"""The reference's target sketch in pieces, for a target too large for
one numpy pass (a UniProtKB/Swiss-Prot-sized one: ~207 M residues, which
``sketch.sketch`` would hash with ~15 GB of temporaries).

``sketch_fasta_chunked`` reads the FASTA as ``sketch.sketch_fasta`` does,
splits the proteins into contiguous chunks of about equal residues, and
has a pool of worker processes run ``sketch.clean`` and then
``sketch.sketch`` itself over each chunk; the chunks are concatenated in
order. A protein's sketch depends on that protein alone, so the result is
bit-equal to the one-pass sketch; ``sketch.postings`` (the same stable
argsort) then builds the postings from it.

The workers are spawned, not forked (the caller may hold CUDA and
threads), so a script that calls this must guard its entry point with
``if __name__ == "__main__"``, as ``kbench/run.py`` does.
"""

from __future__ import annotations

import multiprocessing
import os
from typing import List, Optional

import numpy as np

from . import sketch

CHUNK_RESIDUES = 4_000_000  # a worker's temporaries stay near 0.3 GB
# the largest peak resident memory of a worker in the last pooled call, in
# bytes: ``VmHWM``, counted from the worker's own start (``ru_maxrss`` would
# count the parent's pages at the fork that made it); 0 before any pooled
# call, or where the system reports no ``VmHWM``
last_worker_peak_bytes = 0


def _peak_rss() -> int:
    try:
        with open("/proc/self/status") as f:
            return next(int(line.split()[1]) * 1024 for line in f if line.startswith("VmHWM:"))
    except (OSError, StopIteration):
        return 0


def _sketch_chunk(args) -> tuple:
    seqs, k, scaled, moltype = args
    s = sketch.sketch([], [sketch.clean(x) for x in seqs], k, scaled, moltype)
    return s.mins, s.abundances, np.diff(s.offsets), _peak_rss()


def chunk_bounds(lengths: np.ndarray, chunks: int) -> List[int]:
    """Protein indices that cut ``lengths`` into at most ``chunks``
    contiguous, non-empty pieces of about equal residues (first 0, last
    ``len(lengths)``; one protein a piece where ``chunks`` reaches it)."""
    n = len(lengths)
    if chunks >= n:
        return list(range(n + 1))
    chunks = max(1, int(chunks))
    ends = np.cumsum(lengths)
    cuts = np.searchsorted(ends, int(ends[-1]) * np.arange(1, chunks) / chunks, "left") + 1
    return sorted({0, n, *(int(c) for c in cuts if 0 < c < n)})


def sketch_chunked(names: List[str], seqs: List[bytes], k: int, scaled: int, moltype: str,
                   chunks: Optional[int] = None, workers: Optional[int] = None) -> sketch.Sketches:
    """``sketch.sketch(names, [sketch.clean(s) for s in seqs], ...)``
    computed over ``chunks`` contiguous pieces (default: one per
    ``CHUNK_RESIDUES``) by ``workers`` processes (default: the CPUs this
    process may run on; 1 runs them here)."""
    global last_worker_peak_bytes
    lengths = np.array([len(s) for s in seqs], np.int64)
    if chunks is None:
        chunks = -(-int(lengths.sum()) // CHUNK_RESIDUES)
    bounds = chunk_bounds(lengths, chunks)
    jobs = [(seqs[a:b], k, scaled, moltype) for a, b in zip(bounds[:-1], bounds[1:])]
    if not jobs:
        return sketch.sketch(names, seqs, k, scaled, moltype)
    workers = min(workers or len(os.sched_getaffinity(0)), len(jobs))
    if workers <= 1:
        parts = [_sketch_chunk(j) for j in jobs]
    else:
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            parts = pool.map(_sketch_chunk, jobs, chunksize=1)
        last_worker_peak_bytes = max(p[3] for p in parts)
    offsets = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum(np.concatenate([p[2] for p in parts]), out=offsets[1:])
    return sketch.Sketches(list(names), np.concatenate([p[0] for p in parts]),
                           np.concatenate([p[1] for p in parts]), offsets)


def sketch_fasta_chunked(path: str, k: int, scaled: int, moltype: str, chunks: Optional[int] = None,
                         workers: Optional[int] = None) -> sketch.Sketches:
    names, seqs = sketch.read_fasta(path)
    return sketch_chunked(names, seqs, k, scaled, moltype, chunks, workers)
