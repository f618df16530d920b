"""Milliseconds of the block's k-mer sidecar (``write_kmer_table_for_index``:
the window-hash pass, the strings and the parquet write) per block in the
window: the harness's host-clock span ``kmers``."""


def read(run):
    blocks = len(run.records)
    ms = run.span_s("kmers") * 1e3
    return ms / blocks if blocks and ms else None
