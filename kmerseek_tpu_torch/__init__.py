"""kmerseek-tpu on PyTorch: the same index and search, for NVIDIA GPUs.

A port of the JAX package ``kmerseek_tpu`` beside it, module for
module: FASTA ingest, FracMinHash sketching over the protein / dayhoff
/ hp alphabets, the ``.ksx`` index with its inverted postings, and
manysearch with the sparse device cross-check. The fused sketch kernel
is hand-written CUDA for Hopper (``csrc/masked_sketch.cu``); the rest
is plain PyTorch. Results are bit-equal to the JAX package: hashes,
mins, abundances, posting order, hit lists and CSV bytes.

This package imports nothing of ``kmerseek_tpu`` and never imports jax.
Entry points run on the CUDA device unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
