"""Milliseconds a block of the stitch less its scans: self time of the
program's ``stitch.join``, ``stitch.segments``, ``stitch.csv`` and
``stitch.write`` spans (the joins, the stitched strings and the report,
the CSV and the writes), per block in the window."""

from kbench.program_spans import window_ms_per_block


def read(run):
    return window_ms_per_block(run, "stitch.join", "stitch.segments", "stitch.csv", "stitch.write")
