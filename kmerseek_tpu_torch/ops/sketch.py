"""Batched FracMinHash sketching: the device sketch stage and its host
finalize (counterpart of ``kmerseek_tpu/ops/sketch.py``).

  (B, L) uint8 residues ── fused kernel (``ops.sketch_cuda``) ──►
  (B, W) sentinel-masked int64 keys + (B,) kept counts
        ── row sort on the sign-flipped keys ──► kept hashes ascending,
  duplicates adjacent, sentinels last ── ``first`` run mask ──►
  host run-length dedup (``finalize_sorted_np``) → mins + abundances.

Keys are u64 bits in int64 (``ops.u64``). Sorting the sign-flipped
value orders them as unsigned, so the u64::MAX sentinel (-1) sorts
last; equal keys are identical values, so sort stability is moot.
"""

from __future__ import annotations

import numpy as np
import torch

from .sketch_cuda import masked_window_keys
from .sketch_np import merge_sketches_np  # noqa: F401  (re-export)
from .u64 import sort_key


def sorted_window_hashes(
    seqs: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k: int,
    scaled: int,
    moltype: str,
    capacity: int,
):
    """Device sketch stage: kernel → row sort → ``first`` mask.

    Returns ``(s_keys, first, n_kept)``, shaped (B, capacity) /
    (B, capacity) / (B,):

      * slots j < n_kept hold the sorted kept hashes (int64 bits, with
        duplicates); the rest hold the -1 sentinel;
      * ``first[j]`` marks the first slot of each distinct value
        (Σ first = sketch size). Validity comes from ``j < n_kept``,
        never from the value: under scaled=1 a real hash may equal the
        sentinel;
      * overflow is detectable as n_kept > capacity.
    """
    keys, n_kept = masked_window_keys(
        seqs, lengths, k=k, scaled=scaled, moltype=moltype
    )
    s_keys = sort_key(torch.sort(sort_key(keys), dim=1).values)
    B, W = s_keys.shape
    if W < capacity:  # short-sequence bucket: pad out to the full slot count
        s_keys = torch.nn.functional.pad(s_keys, (0, capacity - W), value=-1)
    s_keys = s_keys[:, :capacity]
    idx = torch.arange(capacity, device=s_keys.device)
    valid = idx[None, :] < n_kept[:, None]
    prev_same = torch.zeros_like(valid)
    prev_same[:, 1:] = s_keys[:, 1:] == s_keys[:, :-1]
    first = valid & ~prev_same
    return s_keys, first, n_kept


def finalize_sorted_np(s_keys, first, n_kept):
    """Host finalize of ``sorted_window_hashes`` → (mins, abund) lists.

    Vectorized run-length dedup: one ``flatnonzero`` over the whole
    batch's ``first`` mask (row-major, so firsts stay grouped by row and
    ascending within a row); each run ends at the next first in the
    same row or at the row's kept count. Accepts tensors or numpy
    arrays; returns per-row uint64 mins and int64 abundances."""
    if isinstance(s_keys, torch.Tensor):
        s_keys = s_keys.cpu().numpy()
        first = first.cpu().numpy()
        n_kept = n_kept.cpu().numpy()
    h64 = np.ascontiguousarray(s_keys).view(np.uint64)
    first = np.asarray(first)
    n_kept = np.asarray(n_kept).astype(np.int64)
    B, S = h64.shape
    if n_kept.max(initial=0) > S:
        raise ValueError(f"sketch capacity overflow: {n_kept.max()} > {S}")
    flat_first = np.flatnonzero(first)
    rows = flat_first // S
    pos = flat_first - rows * S
    mins_flat = h64.reshape(-1)[flat_first]
    ends = np.empty(len(pos), np.int64)
    if len(pos):
        same_row = rows[1:] == rows[:-1]
        ends[:-1] = np.where(same_row, pos[1:], n_kept[rows[:-1]])
        ends[-1] = n_kept[rows[-1]]
    ab_flat = ends - pos
    offs = np.zeros(B + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=B), out=offs[1:])
    mins_out = [mins_flat[offs[i]:offs[i + 1]] for i in range(B)]
    ab_out = [ab_flat[offs[i]:offs[i + 1]] for i in range(B)]
    return mins_out, ab_out


def sketch_capacity(max_len: int, k: int, scaled: int) -> int:
    """A safe per-row slot count for (max_len, k, scaled) batches.

    Expected retained fraction is 1/scaled; allow generous slack plus a
    constant floor. scaled=1 keeps every window, so capacity must be the
    full window count.
    """
    w = max(max_len - k + 1, 1)
    if scaled <= 1:
        return w
    est = int(w * 3.0 / scaled) + 64
    return min(w, est)
