"""Milliseconds of the ``.sig.zip`` write (``KmerseekIndex.sig``) per million residues indexed in the window:
the harness's host-clock span ``sigzip`` summed over the window's requests."""


def read(run):
    mres = sum(w["residues"] for i, w in run.work.items() if i >= 0) / 1e6
    ms = run.span_s("sigzip") * 1e3
    return ms / mres if mres and ms else None
