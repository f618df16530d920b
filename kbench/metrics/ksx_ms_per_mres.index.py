"""Milliseconds of the posting build and the ``.ksx`` write (``KmerseekIndex.ksx`` / ``ProteomeIndex.save``) per million residues indexed in the window:
the harness's host-clock span ``ksx`` summed over the window's requests."""


def read(run):
    mres = sum(w["residues"] for i, w in run.work.items() if i >= 0) / 1e6
    ms = run.span_s("ksx") * 1e3
    return ms / mres if mres and ms else None
