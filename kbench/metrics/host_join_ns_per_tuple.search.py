"""Nanoseconds of ``manysearch``'s host join per (query hash, posting)
tuple it expands in the window: self time of the program's
``search.join`` spans over their ``search.tuples`` counter, so a larger
target's longer posting runs do not read as a slower join."""

from kbench.program_spans import counted, self_ms, window_spans


def read(run):
    got = window_spans(run)
    if got is None:
        return None
    tuples = counted(got, "search.tuples", "search.join")
    ms = self_ms(got, "search.join")
    return ms * 1e6 / tuples if tuples and ms else None
