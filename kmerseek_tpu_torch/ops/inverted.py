"""Inverted posting index: every target's hashes in one sorted array
(counterpart of ``kmerseek_tpu/ops/inverted.py``).

* ``InvertedIndex`` — the host arrays, field for field the JAX
  package's (``g_hi``/``g_lo`` uint32 hash words, ``tid``/``ab`` int32,
  the top-bits bucket table), so ``.ksx`` directories are shared.
* ``build_inverted_np`` — host build: stable argsort of the CSR hashes.
* ``build_inverted`` — the device build: one stable ``torch.sort`` of the
  sign-flipped int64 hashes (unsigned order). The CSR concatenation is
  tid-ascending, so a stable sort leaves equal hashes tid-ascending —
  the same order as the host build. Run statistics and the bucket
  table come from elementwise and cumulative ops on the device; the
  sorted postings stay there for the search (``device_postings``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from .u64 import lsr, sort_key, split_np, join_np, u64_np_to_tensor

# top hash bits of the bucket table: a probe binary-searches only its
# bucket's span of the sorted postings
BUCKET_BITS = 20


class InvertedIndex(NamedTuple):
    """Host-side flattened posting arrays."""

    g_hi: np.ndarray  # (N,) uint32 — hash high words, globally sorted
    g_lo: np.ndarray  # (N,) uint32
    tid: np.ndarray  # (N,) int32 — owning target of each posting
    ab: np.ndarray  # (N,) int32 — abundance of the hash in that target
    n_targets: int
    max_run: int  # longest run of equal hashes (max document frequency)
    bucket_starts: np.ndarray = None  # (2^BUCKET_BITS + 1,) int32
    max_span: int = 0  # widest bucket (static binary-search depth)
    bucket_shift: int = 48  # hash >> shift = bucket id (scale-aware)

    @property
    def n_postings(self) -> int:
        return len(self.g_hi)

    def g64(self) -> np.ndarray:
        """Sorted uint64 posting hashes (host searchsorted joins)."""
        return join_np(self.g_hi, self.g_lo)

    def with_buckets(self) -> "InvertedIndex":
        """Attach the bucket start table (computed on host, persisted).

        The shift anchors at the max hash's leading zeros (the scaled
        filter empties the top log2(scaled) bits), clamped at 32 so the
        bucket id comes from the high word alone."""
        if self.bucket_starts is not None:
            return self
        n = len(self.g_hi)
        max_hash = (int(self.g_hi[-1]) << 32) | int(self.g_lo[-1]) if n else 0
        shift = _bucket_shift(max_hash)
        tops = (self.g_hi >> np.uint32(shift - 32)).astype(np.int64)
        counts = np.bincount(tops, minlength=1 << BUCKET_BITS)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        starts = np.append(starts, n).astype(np.int32)
        max_span = int(np.diff(starts).max(initial=1))
        return self._replace(
            bucket_starts=starts, max_span=max_span, bucket_shift=shift
        )


def _bucket_shift(max_hash: int) -> int:
    lead_z = 64 - max_hash.bit_length() if max_hash else 0
    return max(64 - BUCKET_BITS - lead_z, 32)


def build_inverted_np(
    mins: np.ndarray, abundances: np.ndarray, offsets: np.ndarray
) -> InvertedIndex:
    """Build from a ProteomeIndex's CSR arrays (host, numpy)."""
    T = len(offsets) - 1
    counts = np.diff(offsets)
    tid = np.repeat(np.arange(T, dtype=np.int32), counts)
    mins = np.asarray(mins, np.uint64)
    order = np.argsort(mins, kind="stable")
    g = mins[order]
    tid = tid[order]
    ab = np.asarray(abundances)[order].astype(np.int32)
    if len(g):
        boundaries = np.flatnonzero(np.diff(g) != 0)
        run_starts = np.concatenate([[0], boundaries + 1])
        run_ends = np.concatenate([boundaries + 1, [len(g)]])
        max_run = int((run_ends - run_starts).max())
    else:
        max_run = 1
    g_hi, g_lo = split_np(g)
    return InvertedIndex(g_hi, g_lo, tid, ab, T, max_run).with_buckets()


class DevicePostings(NamedTuple):
    """The postings of one index on one device, as the search reads them."""

    gk: torch.Tensor  # (N,) int64 sign-flipped sorted hashes (ascending)
    tid: torch.Tensor  # (N,) int64
    ab: torch.Tensor  # (N,) int64
    bucket_starts: torch.Tensor  # (2^BUCKET_BITS + 1,) int64


# device copies keyed by the identity of the host ``g_hi`` array (each
# build or load allocates it fresh; the entry holds a strong reference,
# so the id stays unique while cached) and the device. Two slots: a
# search touches at most a target and a query index.
_DEVICE_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_DEVICE_CACHE_SLOTS = 2


def _cache_put(inv: InvertedIndex, device: torch.device, dp: DevicePostings) -> None:
    key = (id(inv.g_hi), str(device))
    _DEVICE_CACHE[key] = (inv.g_hi, dp)
    _DEVICE_CACHE.move_to_end(key)
    while len(_DEVICE_CACHE) > _DEVICE_CACHE_SLOTS:
        _DEVICE_CACHE.popitem(last=False)


def device_postings(inv: InvertedIndex, device) -> DevicePostings:
    """The device copy of ``inv``'s postings, uploaded once and cached."""
    device = torch.device(device)
    key = (id(inv.g_hi), str(device))
    ent = _DEVICE_CACHE.get(key)
    if ent is not None and ent[0] is inv.g_hi:
        _DEVICE_CACHE.move_to_end(key)
        return ent[1]
    inv = inv.with_buckets()
    g = u64_np_to_tensor(inv.g64(), device)
    dp = DevicePostings(
        sort_key(g),
        torch.from_numpy(np.asarray(inv.tid, np.int64)).to(device),
        torch.from_numpy(np.asarray(inv.ab, np.int64)).to(device),
        torch.from_numpy(np.asarray(inv.bucket_starts, np.int64)).to(device),
    )
    _cache_put(inv, device, dp)
    return dp


def build_inverted(mins, abundances, offsets, device) -> InvertedIndex:
    """Device inverted build (the ``ProteomeIndex.inverted`` entry point).

    Bit-equal to ``build_inverted_np``: same posting order, ``max_run``
    and bucket table. The sorted postings stay cached on ``device``."""
    device = torch.device(device)
    mins = np.asarray(mins, np.uint64)
    N = len(mins)
    if N == 0:
        return build_inverted_np(mins, abundances, offsets)
    T = len(offsets) - 1
    counts = torch.from_numpy(np.diff(np.asarray(offsets, np.int64))).to(device)
    tid = torch.repeat_interleave(
        torch.arange(T, device=device), counts, output_size=N
    )
    ab = torch.from_numpy(np.asarray(abundances, np.int64)).to(device)
    keys = sort_key(u64_np_to_tensor(mins, device))
    gk, order = torch.sort(keys, stable=True)
    tid = tid[order]
    ab = ab[order]
    iota = torch.arange(N, device=device)
    isnew = torch.ones(N, dtype=torch.bool, device=device)
    isnew[1:] = gk[1:] != gk[:-1]
    run_start = torch.cummax(torch.where(isnew, iota, 0), dim=0).values
    g = sort_key(gk)  # the u64 bits again
    shift = _bucket_shift(int(g[-1].item()) & ((1 << 64) - 1))
    tops = lsr(g, shift)
    bcounts = torch.bincount(tops, minlength=1 << BUCKET_BITS)
    starts = torch.zeros((1 << BUCKET_BITS) + 1, dtype=torch.int64, device=device)
    starts[1:] = torch.cumsum(bcounts, 0)
    max_run = int((iota - run_start + 1).max().item())
    max_span = max(int(bcounts.max().item()), 1)
    g_np = g.cpu().numpy().view(np.uint64)
    g_hi, g_lo = split_np(g_np)
    inv = InvertedIndex(
        g_hi,
        g_lo,
        tid.to(torch.int32).cpu().numpy(),
        ab.to(torch.int32).cpu().numpy(),
        T,
        max_run,
        bucket_starts=starts.to(torch.int32).cpu().numpy(),
        max_span=max_span,
        bucket_shift=shift,
    )
    _cache_put(inv, device, DevicePostings(gk, tid, ab, starts))
    return inv
