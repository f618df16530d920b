"""kmerseek-tpu on PyTorch: the same index and search, for NVIDIA GPUs.

A port of the JAX package ``kmerseek_tpu`` beside it, module for
module: FASTA ingest, FracMinHash sketching over the protein / dayhoff
/ hp alphabets, the ``.ksx`` index with its inverted postings,
manysearch and multisearch with the sparse device cross-check, the
dense inverted engine, and ``parallel/`` (process groups, the
hash-range-sharded index, sharded search over a device mesh). The sketch kernels and the row sort are
hand-written CUDA for Hopper (``csrc/``); the rest is plain PyTorch. Results are bit-equal to the JAX package: hashes,
mins, abundances, posting order, hit lists and CSV bytes.

This package imports nothing of ``kmerseek_tpu`` and never imports jax.
Entry points run on the CUDA device unless the caller asks for the CPU.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API: ``kmerseek_tpu_torch.ProteomeIndex`` etc.
    without importing torch at package import time."""
    if name in ("ProteomeIndex", "IndexConfig"):
        from .core import index as _index

        return getattr(_index, name)
    if name in (
        "manysearch",
        "multisearch",
        "do_manysearch",
        "do_multisearch",
        "manysearch_columns",
        "multisearch_columns",
        "write_search_csv_columns",
        "write_search_parquet",
    ):
        from .core import search as _search

        return getattr(_search, name)
    if name in (
        "ShardedProteomeIndex",
        "build_sharded_index",
        "load_sharded_index",
        "sharded_manysearch_columns",
        "sharded_multisearch_columns",
    ):
        from .parallel import sharded as _sharded

        return getattr(_sharded, name)
    if name == "build_distributed_index":
        from .parallel.multihost import build_distributed_index

        return build_distributed_index
    if name == "Signature":
        from .core.signature import Signature

        return Signature
    raise AttributeError(name)
