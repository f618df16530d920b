"""Host-side (pure numpy) sketch helpers (counterpart of
``kmerseek_tpu/ops/sketch_np.py``, copied)."""

from __future__ import annotations

import numpy as np


def merge_sketches_np(mins_list, abund_list):
    """Union ("combined minhash") of many sketches on host.

    Mirrors the reference's combined KmerMinHash across all proteins
    (index.rs:823-827): hash set union with summed abundances.
    """
    if not mins_list:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    allm = np.concatenate([np.asarray(m, np.uint64) for m in mins_list])
    alla = np.concatenate([np.asarray(a, np.int64) for a in abund_list])
    uniq, inv = np.unique(allm, return_inverse=True)
    sums = np.zeros(len(uniq), np.int64)
    np.add.at(sums, inv, alla)
    return uniq, sums
