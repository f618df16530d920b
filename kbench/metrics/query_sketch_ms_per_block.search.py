"""Milliseconds of sketching a query block (``ProteomeIndex.build``) per block in the window: the harness's
host-clock span ``query_sketch`` summed over the window's blocks."""


def read(run):
    blocks = len(run.records)
    ms = run.span_s("query_sketch") * 1e3
    return ms / blocks if blocks and ms else None
