"""Milliseconds of ``write_search_csv`` per block in the window: the harness's
host-clock span ``csv`` summed over the window's blocks."""


def read(run):
    blocks = len(run.records)
    ms = run.span_s("csv") * 1e3
    return ms / blocks if blocks and ms else None
