"""Sparse hit-list search: (query, target, count, weight) for every pair
that shares a hash (counterpart of ``kmerseek_tpu/ops/sparse_search.py``).

A sort-segment pipeline on the device, in plain PyTorch ops:

1. every query hash finds its run in the sorted postings: a bucketed
   lower bound (one gather into the top-bits bucket table, then
   ``log2(max_span)`` bisect rounds) and an upper bound bisected within
   ``max_run`` of it;
2. each run expands to (q, t, abundance) tuples — only the true matches,
   laid out by an exclusive cumsum of the run lengths;
3. one sort on the packed ``q * n_targets + t`` key groups equal pairs;
   run heads give the pairs, counts are run lengths, and weights are
   int64 prefix-sum differences (exact; no limb split).

Hits come out (q, t)-ascending. ``q_chunk`` bounds the expansion in the
query dimension, ``run_chunk`` in the run dimension (posting runs are
probed in offset windows and the partial lists merged additively).
Learned hints, async prefetch and streaming are not part of this port.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .inverted import InvertedIndex, build_inverted_np, device_postings, probe_runs

# default run-offset tile: corpora whose worst hash occurs in more
# targets than this are probed in windows of this many postings
_RUN_TILE = 2048


class SparseHits(NamedTuple):
    """Host-side trimmed hit list."""

    q: np.ndarray  # (H,) int32 query row of each hit pair
    t: np.ndarray  # (H,) int32 target id
    count: np.ndarray  # (H,) int32 shared-hash count
    weight: np.ndarray  # (H,) int64 summed target abundance
    n_hits: int  # true number of hit pairs (may exceed H on overflow)


def _empty_hits() -> SparseHits:
    z = np.zeros(0, np.int32)
    return SparseHits(z, z, z, z.astype(np.int64), 0)


def _block_hits(
    inv: InvertedIndex, dp, q_keys, q_valid, *, run_offset: int, tile: int
) -> SparseHits:
    """All hit pairs of one query block within one run-offset window."""
    Q, S = q_keys.shape
    pos, ub = probe_runs(
        dp, q_keys, max_run=inv.max_run,
        span_steps=max(int(inv.max_span).bit_length(), 1), bucket_shift=inv.bucket_shift,
    )
    cnt = torch.where(q_valid, ub - pos, torch.zeros_like(pos))
    cnt = torch.clamp(cnt - run_offset, 0, tile).reshape(-1)
    M = int(cnt.sum().item())
    if M == 0:
        return _empty_hits()
    P = cnt.shape[0]
    probe = torch.repeat_interleave(
        torch.arange(P, device=cnt.device), cnt, output_size=M
    )
    offs = torch.cumsum(cnt, 0) - cnt
    rank = torch.arange(M, device=cnt.device) - offs[probe]
    idx = pos.reshape(-1)[probe] + run_offset + rank
    T = int(inv.n_targets)
    key, order = torch.sort((probe // S) * T + dp.tid[idx])
    w = dp.ab[idx][order]
    head = torch.ones(M, dtype=torch.bool, device=key.device)
    head[1:] = key[1:] != key[:-1]
    starts = torch.nonzero(head).reshape(-1)
    ends = torch.cat([starts[1:], starts.new_tensor([M])])
    csum = torch.cumsum(w, 0)
    weight = csum[ends - 1] - torch.where(
        starts > 0, csum[torch.clamp(starts - 1, min=0)], torch.zeros_like(starts)
    )
    pair = key[starts]
    return SparseHits(
        (pair // T).to(torch.int32).cpu().numpy(),
        (pair % T).to(torch.int32).cpu().numpy(),
        (ends - starts).to(torch.int32).cpu().numpy(),
        weight.cpu().numpy(),
        int(starts.shape[0]),
    )


def _trim(h: SparseHits, capacity: Optional[int]) -> SparseHits:
    if capacity is None or h.n_hits <= capacity:
        return h
    return SparseHits(
        h.q[:capacity], h.t[:capacity], h.count[:capacity], h.weight[:capacity],
        h.n_hits,
    )


def _merge_partial_hits(parts: list, capacity: Optional[int]) -> SparseHits:
    """Additive merge of run-offset tiles: a (q, t) pair may surface in
    several tiles, so lexsort by (q, t), segment, and sum."""
    q = np.concatenate([p.q for p in parts])
    t = np.concatenate([p.t for p in parts])
    count = np.concatenate([p.count for p in parts])
    weight = np.concatenate([p.weight for p in parts])
    if len(q) == 0:
        return _empty_hits()
    order = np.lexsort((t, q))
    q, t, count, weight = q[order], t[order], count[order], weight[order]
    head = np.empty(len(q), bool)
    head[0] = True
    head[1:] = (q[1:] != q[:-1]) | (t[1:] != t[:-1])
    starts = np.flatnonzero(head)
    merged = SparseHits(
        q[starts],
        t[starts],
        np.add.reduceat(count, starts).astype(np.int32),
        np.add.reduceat(weight, starts).astype(np.int64),
        len(starts),
    )
    return _trim(merged, capacity)


def _round_capacity(capacity: Optional[int]) -> Optional[int]:
    """Explicit capacities trim at a 128-slot multiple (the JAX engine's
    output-buffer quantization), so an overflowing list keeps as many
    hits there as here."""
    if capacity is None:
        return None
    return max(((capacity + 127) // 128) * 128, 128)


def _search_block(inv, dp, q_keys, q_valid, capacity, tile) -> SparseHits:
    if inv.max_run > tile:
        parts = [
            _block_hits(inv, dp, q_keys, q_valid, run_offset=off, tile=tile)
            for off in range(0, inv.max_run, tile)
        ]
        return _merge_partial_hits(parts, capacity)
    hits = _block_hits(inv, dp, q_keys, q_valid, run_offset=0, tile=inv.max_run)
    return _trim(hits, _round_capacity(capacity))


def sparse_search(
    index,
    q_keys: torch.Tensor,
    q_valid: torch.Tensor,
    capacity: Optional[int] = None,
    q_chunk: Optional[int] = None,
    run_chunk: Optional[int] = None,
) -> SparseHits:
    """ProteomeIndex + query block → trimmed (q, t)-ascending hit list.

    Args:
      index: anything with an ``inverted`` InvertedIndex (a
        ``ProteomeIndex``), or the CSR arrays ``mins``/``abundances``/
        ``offsets`` to build one on the host.
      q_keys: ``(Q, S)`` int64 query hashes (u64 bits) on the search
        device; ``q_valid`` the ``(Q, S)`` bool mask of real slots.
      capacity: trims the list (``n_hits`` keeps the true count).
      q_chunk: process queries in chunks of this many rows.
      run_chunk: run-offset tile width (default 2048).
    """
    inv = getattr(index, "inverted", None)
    if not isinstance(inv, InvertedIndex):
        inv = build_inverted_np(index.mins, index.abundances, index.offsets)
    Q, S = q_keys.shape
    if inv.n_postings == 0:
        return _empty_hits()
    dp = device_postings(inv, q_keys.device)
    q_valid = q_valid.to(torch.bool)
    tile = run_chunk if run_chunk is not None else _RUN_TILE
    if q_chunk is not None and Q > q_chunk:
        tile = max(1, min(tile, (2**31 - 1) // max(q_chunk * S, 1)))
        parts = [
            _search_block(
                inv, dp, q_keys[c : c + q_chunk], q_valid[c : c + q_chunk],
                capacity, tile,
            )
            for c in range(0, Q, q_chunk)
        ]
        return SparseHits(
            np.concatenate(
                [p.q + np.int32(i * q_chunk) for i, p in enumerate(parts)]
            ),
            np.concatenate([p.t for p in parts]),
            np.concatenate([p.count for p in parts]),
            np.concatenate([p.weight for p in parts]),
            sum(p.n_hits for p in parts),
        )
    tile = max(1, min(tile, (2**31 - 1) // max(Q * S, 1)))
    return _search_block(inv, dp, q_keys, q_valid, capacity, tile)
