"""Milliseconds of the stitched tail (``write_stitched``: both sidecars'
scans, the joins, the stitch, the CSV and the report) per block in the
window: the harness's host-clock span ``stitch``."""


def read(run):
    blocks = len(run.records)
    ms = run.span_s("stitch") * 1e3
    return ms / blocks if blocks and ms else None
