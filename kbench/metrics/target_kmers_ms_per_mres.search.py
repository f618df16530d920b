"""Milliseconds of the target's k-mer sidecar per million target residues
in set-up: the harness's span ``target_kmers`` around
``write_kmer_table_for_index`` over the Mres that the target build
validated."""

from kbench.program_spans import target_residues_m


def read(run):
    mres = target_residues_m(run)
    ms = sum(t1 - t0 for n, _r, t0, t1 in run.spans if n == "target_kmers") * 1e3
    return ms / mres if mres and ms else None
