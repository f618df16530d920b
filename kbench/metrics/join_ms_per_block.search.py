"""Milliseconds of ``manysearch`` (host join, columns, row dicts and the device cross-check) per block in the window: the harness's
host-clock span ``join`` summed over the window's blocks."""


def read(run):
    blocks = len(run.records)
    ms = run.span_s("join") * 1e3
    return ms / blocks if blocks and ms else None
