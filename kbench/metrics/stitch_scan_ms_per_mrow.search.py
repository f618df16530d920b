"""Milliseconds of the sidecar scans per million sidecar rows read in the
window: self time of the program's ``stitch.scan`` spans over their
``stitch.rows_scanned`` counter, so a larger target sidecar does not
read as a slower scan."""

from kbench.program_spans import counted, self_ms, window_spans


def read(run):
    got = window_spans(run)
    if got is None:
        return None
    mrows = counted(got, "stitch.rows_scanned", "stitch.scan") / 1e6
    ms = self_ms(got, "stitch.scan")
    return ms / mrows if mrows and ms else None
