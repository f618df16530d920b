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
* ``inverted_pair_stats`` / ``inverted_search`` — the dense engine:
  ``(Q, T)`` intersect counts and abundance-weighted sums of a query
  block against the postings. Every probe finds its run of equal hashes
  by a lower and an upper bound (through the bucket table, or over the
  whole array where the postings carry none, as a hash-range shard's
  do), the runs expand to (query, target) tuples in bounded chunks, and
  two ``index_add_`` calls sum them into the flattened matrices. Integer
  adds, so the order cannot show. Plain PyTorch, as the JAX engine is
  plain ``jnp``; it is the oracle that sharded search is held against.
  The learned block hints of the JAX package (``dense_block_hint``,
  ``note_dense_block``, ``autotune_dense_block``) are not part of this
  port yet.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple, Optional, Tuple

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


def longest_run(g: np.ndarray) -> int:
    """Longest run of equal values in a sorted array (1 for an empty one)."""
    if not len(g):
        return 1
    boundaries = np.flatnonzero(np.diff(g) != 0)
    run_starts = np.concatenate([[0], boundaries + 1])
    run_ends = np.concatenate([boundaries + 1, [len(g)]])
    return int((run_ends - run_starts).max())


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
    g_hi, g_lo = split_np(g)
    return InvertedIndex(g_hi, g_lo, tid, ab, T, longest_run(g)).with_buckets()


class DevicePostings(NamedTuple):
    """The postings of one index on one device, as the search reads them."""

    gk: torch.Tensor  # (N,) int64 sign-flipped sorted hashes (ascending)
    tid: torch.Tensor  # (N,) int64
    ab: torch.Tensor  # (N,) int64
    # (2^BUCKET_BITS + 1,) int64; None for postings without a bucket
    # table, which the dense engine then searches over their whole range
    bucket_starts: Optional[torch.Tensor]


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


def clear_device_postings(inv: Optional[InvertedIndex] = None) -> None:
    """Release cached device copies of postings (device memory and the
    host references that keep them): of ``inv`` alone, on every device,
    or of every index when ``inv`` is None. For services that retire an
    index. The sharded slices of ``parallel.dist`` go with them."""
    from ..parallel.dist import clear_sharded_sparse_cache

    clear_sharded_sparse_cache(inv)
    if inv is None:
        _DEVICE_CACHE.clear()
        return
    for key in [k for k, ent in _DEVICE_CACHE.items() if ent[0] is inv.g_hi]:
        del _DEVICE_CACHE[key]


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


# ---------------------------------------------------------------------------
# the dense (Q, T) engine
# ---------------------------------------------------------------------------

# query rows of one dense dispatch: bounds the two (Q, T) matrices
DEFAULT_DENSE_BLOCK = 4096
# (query, target) tuples one expansion may hold (a single probe's run, at
# most max_run postings, is never split)
_DENSE_TUPLE_CHUNK = 1 << 24


def bisect(gk, qk, lo, hi, steps: int, upper: bool):
    """``steps`` rounds of vectorized binary search within [lo, hi):
    the first index whose key is >= ``qk`` (``upper``: > ``qk``). Keys
    are sign-flipped (``u64.sort_key``), so the order is unsigned. The
    ``lo`` update is guarded by ``lo < hi``: a probe above the whole
    span converges on ``hi`` and stays there, so ``upper - lower`` is an
    exact run length."""
    last = gk.shape[0] - 1
    for _ in range(steps):
        mid = (lo + hi) >> 1
        v = gk[torch.clamp(mid, max=last)]
        go_right = (v <= qk) if upper else (v < qk)
        lo = torch.where(go_right & (lo < hi), mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return lo


def probe_runs(
    dp: DevicePostings, q_keys: torch.Tensor, *, max_run: int, span_steps: int, bucket_shift: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[lower, upper)`` posting range of every query hash's run of equal
    hashes (empty where the hash is absent). Bucketed: one gather into
    the top-bits table (the id clamped to its last bucket), then
    ``span_steps`` bisect rounds inside the bucket; without a table,
    ``span_steps`` rounds over the whole array (it must cover log2 N).
    The upper bound is bisected within ``max_run`` of the lower."""
    N = dp.gk.shape[0]
    qk = sort_key(q_keys)
    if dp.bucket_starts is None:
        lo = torch.zeros_like(q_keys)
        hi = torch.full_like(q_keys, N)
    else:
        b = torch.clamp(lsr(q_keys, bucket_shift), max=dp.bucket_starts.shape[0] - 2)
        lo = dp.bucket_starts[b]
        hi = dp.bucket_starts[b + 1]
    pos = bisect(dp.gk, qk, lo, hi, span_steps, False)
    ub = bisect(
        dp.gk, qk, pos, torch.clamp(pos + max_run, max=N),
        max(int(max_run).bit_length(), 1), True,
    )
    return pos, ub


def _tuple_chunks(cnt: torch.Tensor, limit: int):
    """Split probes ``0 .. P`` into consecutive ranges ``[a, b)`` whose run
    lengths ``cnt`` sum to at most ``limit`` (a single longer run goes
    alone). Yields ``(a, b, tuples in the range)``; ranges without tuples
    are skipped."""
    P = cnt.shape[0]
    csum = torch.cumsum(cnt, 0)
    total = int(csum[-1].item()) if P else 0
    if total == 0:
        return
    if total <= limit:
        yield 0, P, total
        return
    c = csum.cpu().numpy()
    a, done = 0, 0
    while a < P:
        b = max(int(np.searchsorted(c, done + limit, side="right")), a + 1)
        b = min(b, P)
        m = int(c[b - 1]) - done
        if m:
            yield a, b, m
        a, done = b, int(c[b - 1])


def inverted_pair_stats(
    dp: DevicePostings,
    q_keys: torch.Tensor,
    q_valid: torch.Tensor,
    *,
    n_targets: int,
    max_run: int,
    span_steps: int,
    bucket_shift: int = 48,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense ``(Q, T)`` int32 intersect counts and int32 abundance-weighted
    sums of one query block (counterpart of the JAX package's
    ``inverted_pair_stats_packed``, equal element for element).

    Args:
      dp: the postings on the query block's device; ``bucket_starts``
        None searches the whole array (``span_steps`` must then cover
        log2 N), the mode of a hash-range shard's slice.
      q_keys: ``(Q, S)`` int64 query hashes (u64 bits).
      q_valid: ``(Q, S)`` bool, real and distinct slots; padding and
        duplicate slots add nothing.
      max_run: longest run of equal hashes in the postings.

    Weights are summed in int64 and cast to int32 at the end: the JAX
    engine's int32 sums while they fit, and the same two's-complement
    bits where they wrap.
    """
    Q, S = q_keys.shape
    T = int(n_targets)
    dev = q_keys.device
    counts = torch.zeros(Q * T, dtype=torch.int32, device=dev)
    weights = torch.zeros(Q * T, dtype=torch.int64, device=dev)
    if dp.gk.shape[0] == 0 or Q * S == 0:
        return counts.view(Q, T), weights.to(torch.int32).view(Q, T)
    pos, ub = probe_runs(
        dp, q_keys, max_run=max_run, span_steps=span_steps, bucket_shift=bucket_shift
    )
    cnt = torch.where(q_valid.to(torch.bool), ub - pos, torch.zeros_like(pos)).reshape(-1)
    pos = pos.reshape(-1)
    for a, b, m in _tuple_chunks(cnt, _DENSE_TUPLE_CHUNK):
        c = cnt[a:b]
        probe = torch.repeat_interleave(torch.arange(b - a, device=dev), c, output_size=m)
        rank = torch.arange(m, device=dev) - (torch.cumsum(c, 0) - c)[probe]
        idx = pos[a:b][probe] + rank
        flat = ((probe + a) // S) * T + dp.tid[idx]
        counts.index_add_(0, flat, torch.ones(m, dtype=torch.int32, device=dev))
        weights.index_add_(0, flat, dp.ab[idx])
    return counts.view(Q, T), weights.to(torch.int32).view(Q, T)


def inverted_search(
    index, q_keys: torch.Tensor, q_valid: torch.Tensor, *, q_block: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ProteomeIndex + query block → dense ``(Q, T)`` int32 counts and
    weighted sums, on the device of ``q_keys`` (counterpart of the JAX
    package's ``inverted_search``).

    Reuses the index's cached or persisted postings; anything else with
    the CSR arrays ``mins``/``abundances``/``offsets`` gets a host build.
    Query blocks of more than ``q_block`` rows (default
    ``DEFAULT_DENSE_BLOCK``) run in block-sized pieces; the result is
    their row concatenation. An index without postings gives zeros."""
    inv = getattr(index, "inverted", None)
    if not isinstance(inv, InvertedIndex):
        inv = build_inverted_np(index.mins, index.abundances, index.offsets)
    Q = q_keys.shape[0]
    if inv.n_postings == 0:  # all-empty target sketches: nothing can match
        z = torch.zeros((Q, inv.n_targets), dtype=torch.int32, device=q_keys.device)
        return z, z.clone()
    dp = device_postings(inv, q_keys.device)
    block = int(q_block) if q_block else DEFAULT_DENSE_BLOCK

    def run(lo: int, hi: int):
        return inverted_pair_stats(
            dp, q_keys[lo:hi], q_valid[lo:hi],
            n_targets=inv.n_targets, max_run=inv.max_run,
            span_steps=max(int(inv.max_span).bit_length(), 1),
            bucket_shift=inv.bucket_shift,
        )

    if Q <= block:
        return run(0, Q)
    parts = [run(lo, lo + block) for lo in range(0, Q, block)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
