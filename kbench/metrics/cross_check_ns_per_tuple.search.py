"""Nanoseconds of the device cross-check of the join per (query hash,
posting) tuple of the host join in the window: self time of the
program's ``search.cross_check`` spans over the ``search.tuples``
counter of its ``search.join`` spans; the device's sparse engine expands
the same tuples."""

from kbench.program_spans import counted, self_ms, window_spans


def read(run):
    got = window_spans(run)
    if got is None:
        return None
    tuples = counted(got, "search.tuples", "search.join")
    ms = self_ms(got, "search.cross_check")
    return ms * 1e6 / tuples if tuples and ms else None
