"""Sparse hit-list search: (query, target, count, weight) for every pair
that shares a hash (counterpart of ``kmerseek_tpu/ops/sparse_search.py``).

A sort-segment pipeline on the device, in plain PyTorch ops
(``inverted_sparse_hits``):

1. every query hash finds its run in the sorted postings: a bucketed
   lower bound (one gather into the top-bits bucket table, then
   ``log2(max_span)`` bisect rounds);
2. each run expands to (q, t, abundance) tuples — rectangular, ``max_run``
   slots a probe, or compact: exactly E slots, the true matches laid out
   by an exclusive cumsum of the run lengths (each slot finds its probe
   by a scatter-max of the segment starts and a ``cummax``);
3. one sort on the packed ``q * (T + 1) + t`` key groups equal pairs; run
   heads give the pairs, and the counts and weights scatter into a
   ``capacity``-slot output buffer (overflow falls off; ``n_hits``
   reports the true count so the host can retry).

Fixed E and capacity make a launch free of host syncs, so block i + 1 can
be enqueued before block i is read (``sparse_search_stream``). The host
learns E and the trimmed fetch length per block shape
(``export_learned_hints`` / ``seed_learned_hints``, persisted in
``.ksx``); an undersized E or capacity is seen in the kernel's exact
counts and retried, never wrong. ``q_chunk`` bounds the expansion in the
query dimension, ``run_chunk`` in the run dimension (posting runs are
probed in offset windows and the partial lists merged additively).

Not ported: the JAX engine's TPU A/B switches (``COMPACT_EXPANSION``,
``RL_LOOKUP``, ``Q_BOUNDS_IO``, ``SKIP_W_UNIT_AB``) and its narrowed
transfer encodings (``compact_io``/``t16``/``tc32``/``w16``/``q_bounds``/
``skip_weights``), whose values are equal after upcast: this engine
always runs the compact expansion with the bisected run length and
fetches int32 columns.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .inverted import (
    _index_inverted,
    bisect,
    device_postings,
    lower_bound,
    max_abundance as _max_abundance,
)
from .u64 import sort_key


def _combine_weight_limbs(w) -> np.ndarray:
    """(…, 2) int32 weight limbs → exact int64 sums (lo + (hi << 16))."""
    w = np.asarray(w)
    return w[..., 0].astype(np.int64) + (w[..., 1].astype(np.int64) << 16)


def _weights_int64(w, wide: bool) -> np.ndarray:
    """Weight buffer → exact int64 sums for either layout."""
    return _combine_weight_limbs(w) if wide else np.asarray(w).astype(np.int64)


def _wide_weights_needed(inv, S: int) -> bool:
    """True when one int32 weight accumulator could wrap: a (q, t) pair
    holds at most one tuple per query slot (≤ S), each weighted by at
    most ``max_abundance(inv)``."""
    return S * max(_max_abundance(inv), 1) >= 2**31


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


def inverted_sparse_hits(
    dp,
    q_keys: torch.Tensor,
    q_valid: torch.Tensor,
    rl: Optional[torch.Tensor] = None,
    *,
    n_targets: int,
    max_run: int,
    capacity: int,
    span_steps: int,
    bucket_shift: int = 48,
    run_offset: int = 0,
    expand_e: Optional[int] = None,
    wide_weights: bool = True,
    true_max_run: Optional[int] = None,
):
    """Bounded sparse (q, t, count, weight) hit list of one query block,
    on the device of ``q_keys``, with no host sync.

    Args:
      dp: ``ops.inverted.DevicePostings`` on that device (``bucket_starts``
        None: full-range bisect; ``span_steps`` must then cover log2 N).
      q_keys, q_valid: ``(Q, S)`` int64 query hashes (u64 bits) and the
        bool mask of real, distinct slots.
      rl: optional ``(N,)`` int32 run lengths (``device_run_lengths``):
        the compact expansion reads a probe's run length there instead
        of bisecting its upper bound.
      max_run: expansion window — run elements ``[run_offset, run_offset
        + max_run)`` of each probe are examined; ``true_max_run`` is the
        index-wide longest run (default ``max_run``), which bounds the
        upper-bound bisect.
      expand_e: None → rectangular ``(max_run, Q, S)`` expansion; E →
        compact, exactly E slots (``stats[1]`` > E means some matches did
        not fit: retry with a larger E).
      wide_weights: weights as ``(capacity, 2)`` int32 16-bit limb sums
        (``_combine_weight_limbs`` gives the exact int64), else one
        ``(capacity,)`` int32 sum (callers prove it cannot wrap).

    Returns ``(q_out, t_out, counts, weights, stats)``: the first
    ``min(n_hits, capacity)`` slots hold the pairs (q, t)-ascending, later
    slots q = Q, t = ``n_targets``, count and weight 0;
    ``stats = [n_hits, m_total]`` int32 (pairs, matched tuples).
    Equal, slot for slot, to the JAX function with its transfer
    encodings off.
    """
    Q, S = q_keys.shape
    dev = q_keys.device
    N = dp.gk.shape[0]
    T1 = int(n_targets) + 1
    if true_max_run is None:
        true_max_run = max_run
    if expand_e is not None and Q * S * max_run >= 2**31:
        # the callers' tiling keeps Q·S·max_run int32-safe, as the JAX
        # engine's int32 offsets need; hold the same contract here
        raise ValueError(
            f"compact expansion overflow risk: Q*S*max_run = {Q * S * max_run} >= 2^31; "
            "lower q_chunk or run_chunk"
        )
    valid_q = q_valid.to(torch.bool)
    qk = sort_key(q_keys)
    pos = lower_bound(dp.gk, dp.bucket_starts, q_keys, span_steps, bucket_shift)
    if expand_e is None:
        p = pos[None] + run_offset + torch.arange(max_run, device=dev).view(-1, 1, 1)
        idx = torch.clamp(p, max=N - 1)
        match = valid_q[None] & (dp.gk[idx] == qk[None]) & (p < N)
        q = torch.where(match, torch.arange(Q, device=dev).view(1, -1, 1), Q).reshape(-1)
        t = torch.where(match, dp.tid[idx], n_targets).reshape(-1)
        w = torch.where(match, dp.ab[idx], 0).reshape(-1)
        m_total = match.sum()
    else:
        E = int(expand_e)
        if rl is not None:
            posc = torch.clamp(pos, max=N - 1)
            matched = valid_q & (dp.gk[posc] == qk) & (pos < N)
            cnt = torch.where(matched, rl[posc].to(torch.int64), 0)
        else:
            # a run never outgrows the index's longest: the upper bound
            # lies in [pos, pos + true_max_run]
            ub = bisect(
                dp.gk, qk, pos, torch.clamp(pos + true_max_run, max=N),
                max(int(true_max_run).bit_length(), 1), True,
            )
            cnt = torch.where(valid_q, ub - pos, 0)
        cnt = torch.clamp(cnt - run_offset, 0, max_run).reshape(-1)
        lbf = (pos + run_offset).reshape(-1)
        offs = torch.cumsum(cnt, 0) - cnt  # exclusive
        m_total = cnt.sum()
        P = cnt.shape[0]
        # each slot's probe: the last probe whose segment starts at or
        # before it (probes sharing an offset are empties then one
        # non-empty probe — the largest id wins the scatter-max)
        seg0 = torch.zeros(E + 1, dtype=torch.int64, device=dev).scatter_reduce_(
            0, torch.clamp(offs, max=E), torch.arange(1, P + 1, device=dev), reduce="amax"
        )
        probe = torch.cummax(seg0[:E], 0).values - 1
        rank = torch.arange(E, device=dev) - offs[probe]
        valid_t = rank < cnt[probe]
        idx = torch.clamp(lbf[probe] + rank, 0, N - 1)
        q = torch.where(valid_t, probe // S, Q)
        t = torch.where(valid_t, dp.tid[idx], n_targets)
        w = torch.where(valid_t, dp.ab[idx], 0)

    # one sort groups equal (q, t) pairs; non-matches sort last
    key, order = torch.sort(q * T1 + t)
    valid = key < Q * T1
    head = valid.clone()
    head[1:] &= key[1:] != key[:-1]
    seg = torch.cumsum(head.to(torch.int64), 0) - 1
    n_hits = head.sum()
    # slot ``capacity`` is the drop slot: overflow and non-matches
    slot = torch.clamp(torch.where(valid, seg, capacity), max=capacity)
    counts = torch.zeros(capacity + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, slot, valid.to(torch.int32))
    wv = torch.where(valid, w[order], 0).to(torch.int32)
    if wide_weights:
        # 16-bit limbs: each limb's sum stays ≤ S·2^16, the combined value
        # is exact past int32
        limbs = torch.zeros((2, capacity + 1), dtype=torch.int32, device=dev)
        limbs[0].index_add_(0, slot, wv & 0xFFFF)
        limbs[1].index_add_(0, slot, wv >> 16)
        weights = limbs[:, :capacity].t().contiguous()
    else:
        weights = torch.zeros(capacity + 1, dtype=torch.int32, device=dev)
        weights.index_add_(0, slot, wv)
        weights = weights[:capacity]
    head_slot = torch.clamp(torch.where(head, seg, capacity), max=capacity)
    t_out = torch.full((capacity + 1,), n_targets, dtype=torch.int32, device=dev)
    t_out.scatter_(0, head_slot, (key % T1).to(torch.int32))
    q_out = torch.full((capacity + 1,), Q, dtype=torch.int32, device=dev)
    q_out.scatter_(0, head_slot, (key // T1).to(torch.int32))
    stats = torch.stack([n_hits, m_total]).to(torch.int32)
    return q_out[:capacity], t_out[:capacity], counts[:capacity], weights, stats


def inverted_sparse_hits_chunks(
    dp,
    q_keys3: torch.Tensor,
    q_valid3: torch.Tensor,
    rl: Optional[torch.Tensor] = None,
    **kw,
):
    """``inverted_sparse_hits`` over a ``(C, Qc, S)`` stack of query
    chunks (keywords as there): ``(C, capacity)`` buffers (weights
    ``(C, capacity, 2)`` when wide) and ``(C, 2)`` stats, enqueued
    without a host sync, so the host reads every chunk's counts at once.
    One chunk's expansion is alive at a time."""
    outs = [inverted_sparse_hits(dp, q_keys3[c], q_valid3[c], rl, **kw) for c in range(q_keys3.shape[0])]
    return tuple(torch.stack([o[i] for o in outs]) for i in range(5))


# per-call cap on the run expansion's window: corpora whose worst hash
# occurs in more targets than this are probed in ``_RUN_TILE``-wide
# offset windows and the partial hit lists merged on the host
_RUN_TILE = 2048


# ---------------------------------------------------------------------------
# learned hints: the compact expansion's E and the trimmed fetch length
# ---------------------------------------------------------------------------

# learned compact-expansion budgets: (id(owner), Q, S) → (weakref to the
# owner, slot count). Seeded at 4·Q·S, then 2× the observed match total
# (quarter-power-of-two steps); the kernel reports the exact total, so an
# undersized E is always retried, never silently wrong. The weak
# reference keeps a retired index's arrays from being kept alive.
_EXPAND_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_EXPAND_CACHE_SLOTS = 64

# device run lengths per index (``device_run_lengths``)
_RL_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_RL_CACHE_SLOTS = 2


def _run_lengths(gk: torch.Tensor) -> torch.Tensor:
    """(N,) int32: the length of the equal-hash run holding posting i."""
    n = gk.shape[0]
    dev = gk.device
    iota = torch.arange(n, device=dev)
    isnew = torch.ones(n, dtype=torch.bool, device=dev)
    isnew[1:] = gk[1:] != gk[:-1]
    start = torch.cummax(torch.where(isnew, iota, 0), 0).values
    nxt = torch.cat([torch.where(isnew, iota, n)[1:], torch.full((1,), n, device=dev)])
    end = torch.flip(torch.cummin(torch.flip(nxt, [0]), 0).values, [0])  # next run start
    return (end - start).to(torch.int32)


def device_run_lengths(inv, device=None) -> torch.Tensor:
    """Cached device ``(N,)`` int32 run lengths of an index's postings
    (``inverted_sparse_hits``' ``rl``), derived on the device from the
    sorted keys. Keyed by a weak reference to the index's cache owner
    and swept on access, so a retired index frees its array. ``device``
    defaults to a ``DeviceInvertedIndex``'s own, else CUDA."""
    if device is None and getattr(inv, "g4_dev", None) is not None:
        dev = inv.g4_dev.device
    else:
        dev = resolve_device(device)
    owner = _cache_owner(inv)
    for k in [k for k, (ref, _v) in list(_RL_CACHE.items()) if ref() is None]:
        del _RL_CACHE[k]
    key = (id(owner), str(dev))
    rl = _cache_get(_RL_CACHE, key, owner)
    if rl is None:
        rl = _run_lengths(device_postings(inv, dev).gk)
        _cache_put(_RL_CACHE, _RL_CACHE_SLOTS, key, owner, rl)
    return rl


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _qpow2(x: int) -> int:
    """Smallest quarter-power-of-two (mantissa {4,5,6,7} · 2^k) ≥ x."""
    x = max(int(x), 1)
    k = max(x.bit_length() - 3, 0)
    return -(-x >> k) << k


def _trim_len(h: int, cap: int) -> int:
    """Fetch length for ``h`` hits: the smallest quarter-power-of-two ≥ h,
    at least 128, at most ``cap``."""
    return min(int(cap), max(128, _qpow2(h)))


def _cache_owner(inv):
    """Identity anchor of the learned-hint caches: the host ``g_hi`` array,
    or ``g4_dev`` of a ``DeviceInvertedIndex`` (touching its ``g_hi``
    would download the postings just to key a cache)."""
    g4_dev = getattr(inv, "g4_dev", None)
    return g4_dev if g4_dev is not None else inv.g_hi


def _cache_get(cache: OrderedDict, key: tuple, owner):
    """The value if the entry's weakly referenced owner is ``owner``."""
    ent = cache.get(key)
    return ent[1] if ent is not None and ent[0]() is owner else None


def _cache_put(cache: OrderedDict, slots: int, key: tuple, owner, value):
    cache[key] = (weakref.ref(owner), value)
    cache.move_to_end(key)
    while len(cache) > slots:
        cache.popitem(last=False)


def export_learned_hints(inv) -> dict:
    """The learned hints of one index, for ``ProteomeIndex.save``'s
    hints.json: ``{"expand": {"Q,S": E}, "hp": {"Q,S,run_offset,cap" or
    "C_pad,Qc,S,run_offset,cap": length}}`` and, once measured,
    ``"dense_block"``. The JAX package writes and reads the same file.
    Hints only shape buffers, never results."""
    from .inverted import _DENSE_BLOCK_CACHE

    owner = _cache_owner(inv)
    out = {"expand": {}, "hp": {}}
    for key, (ref, val) in _EXPAND_CACHE.items():
        if ref() is owner:
            out["expand"][",".join(str(x) for x in key[1:])] = int(val)
    for key, (ref, val) in _HP_CACHE.items():
        if ref() is owner:
            out["hp"][",".join(str(x) for x in key[1:])] = int(val)
    dense = _cache_get(_DENSE_BLOCK_CACHE, (id(owner),), owner)
    if dense:
        out["dense_block"] = int(dense)
    return out


def seed_learned_hints(inv, hints) -> None:
    """Seed the hint caches of a freshly loaded index from hints.json.
    Advisory: a malformed entry is skipped, a non-dict ignored."""
    if not isinstance(hints, dict):
        return
    owner = _cache_owner(inv)
    ex = hints.get("expand")
    for k, v in (ex.items() if isinstance(ex, dict) else ()):
        try:
            Q, S = (int(x) for x in k.split(","))
            v = int(v)
        except (ValueError, TypeError):
            continue
        _cache_put(_EXPAND_CACHE, _EXPAND_CACHE_SLOTS, (id(owner), Q, S), owner, v)
    hp = hints.get("hp")
    for k, v in (hp.items() if isinstance(hp, dict) else ()):
        try:
            shape = tuple(int(x) for x in k.split(","))
            v = int(v)
        except (ValueError, TypeError):
            continue
        _cache_put(_HP_CACHE, _HP_CACHE_SLOTS, (id(owner),) + shape, owner, v)
    dense = hints.get("dense_block")
    if isinstance(dense, (int, float)) and int(dense) > 0:
        from .inverted import note_dense_block

        note_dense_block(inv, int(dense))


def _expand_budget(inv, Q: int, S: int, max_run: int) -> int:
    """E for the compact expansion: learned, else 4·Q·S; at least 128 and
    never above the rectangular worst case."""
    owner = _cache_owner(inv)
    e = _cache_get(_EXPAND_CACHE, (id(owner), Q, S), owner)
    if e is None:
        e = _qpow2(4 * Q * S)
    return max(128, min(e, _qpow2(Q * S * max_run)))


# set while ``warm_sparse_engine`` runs its all-invalid block: its zero
# matches must not shrink the learned budgets
_warming_state = threading.local()


def _note_expand(inv, Q: int, S: int, m_seen: int) -> None:
    if inv is None or getattr(_warming_state, "active", False):
        return
    owner = _cache_owner(inv)
    key = (id(owner), Q, S)
    prev = _cache_get(_EXPAND_CACHE, key, owner) or 0
    _cache_put(_EXPAND_CACHE, _EXPAND_CACHE_SLOTS, key, owner, max(prev, _qpow2(2 * max(m_seen, 64))))


# learned trimmed-fetch lengths: (id(owner), block shape) → (weakref,
# length). With last call's length known, a launch starts copying that
# many hit slots to the host before the counts are read; too short → the
# normal fetch runs, too long → extra bytes only.
_HP_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_HP_CACHE_SLOTS = 64


def _hp_hint(inv, shape: tuple):
    owner = _cache_owner(inv)
    return _cache_get(_HP_CACHE, (id(owner),) + shape, owner)


def _note_hp(inv, shape: tuple, hp: int) -> None:
    if inv is None or getattr(_warming_state, "active", False):
        return
    owner = _cache_owner(inv)
    _cache_put(_HP_CACHE, _HP_CACHE_SLOTS, (id(owner),) + shape, owner, int(hp))


# ---------------------------------------------------------------------------
# launch / finish
# ---------------------------------------------------------------------------


def _start_fetch(tensors: list):
    """Begin copying device tensors to the host without a sync: into
    pinned buffers with ``non_blocking``, then an event on the stream.
    (Into pageable memory such a copy would be synchronous; reading a
    pinned buffer before its event has completed gives stale bytes.)
    Tensors already on the host are taken as they are."""
    if not tensors or tensors[0].device.type != "cuda":
        return tensors, None
    out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for o, t in zip(out, tensors):
        o.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return out, event


def _finish_fetch(fetched) -> list:
    """The numpy arrays of a ``_start_fetch``, once its event completed
    (this waits for the launch's own work only, not for later blocks)."""
    out, event = fetched
    if event is not None:
        event.synchronize()
    return [o.numpy() for o in out]


def _fetch_now(tensors: list) -> list:
    return _finish_fetch(_start_fetch(tensors))


def _hit_views(bufs, sl: int) -> list:
    """The first ``sl`` slots of the four hit buffers (last axis of q, t,
    counts; the slot axis of the weights, which may carry limbs)."""
    q_out, t_out, counts, weights, _stats = bufs
    if q_out.dim() == 1:
        return [q_out[:sl], t_out[:sl], counts[:sl], weights[:sl]]
    return [q_out[:, :sl], t_out[:, :sl], counts[:, :sl], weights[:, :sl]]


def _mk_hits(vs: list, h: int, n: int, wide: bool) -> SparseHits:
    qa, ta, ca, wa = vs
    return SparseHits(
        qa[:h].astype(np.int32), ta[:h].astype(np.int32), ca[:h].astype(np.int32),
        _weights_int64(wa[:h], wide), int(n),
    )


def _launch(run, inv, shape_key, capacity: int, expand_e, retry_on_overflow: bool, Q, S, max_run, wide) -> dict:
    """Enqueue ``run(capacity, expand_e)`` and the copy of its stats (and,
    with a learned fetch length for ``shape_key``, of that many hit
    slots) to the host. No host sync. ``inv`` None: no hints."""
    bufs = run(int(capacity), expand_e)
    hv = _hp_hint(inv, shape_key) if inv is not None else None
    if hv is not None:
        hv = min(int(hv), int(capacity))
    views = _hit_views(bufs, hv) if hv is not None else []
    return {
        "run": run,
        "buffers": bufs,
        "fetch": _start_fetch([bufs[4]] + views),
        "hv": hv,
        "shape_key": shape_key,
        "capacity": int(capacity),
        "expand_e": expand_e,
        "retry_on_overflow": retry_on_overflow,
        "Qn": Q,
        "Sn": S,
        "max_run": max_run,
        "wide": wide,
    }


def _kernel_args(inv, max_run: int, run_offset: int, wide: bool) -> dict:
    binv = inv if inv.bucket_starts is not None else inv.with_buckets()
    return dict(
        n_targets=int(inv.n_targets),
        max_run=max_run,
        span_steps=max(int(binv.max_span).bit_length(), 1),
        bucket_shift=int(binv.bucket_shift),
        run_offset=run_offset,
        wide_weights=wide,
        true_max_run=int(inv.max_run),
    )


def _sparse_launch(inv, q_keys, q_valid, capacity: Optional[int], max_run: int, run_offset: int = 0) -> dict:
    """Dispatch one kernel invocation WITHOUT a host sync; the state dict
    goes to ``_sparse_finish``. Splitting launch from finish lets a
    stream of blocks keep one in flight (``sparse_search_stream``).

    ``capacity`` None: ``min(Q·S·max_run, 4M)`` slots, with one
    exact-capacity retry in the finish if the block overflows."""
    Q, S = (int(x) for x in q_keys.shape)
    retry_on_overflow = capacity is None
    if capacity is None:
        capacity = min(Q * S * max_run, 4 * 1024 * 1024)
    capacity = max(((capacity + 127) // 128) * 128, 128)
    dp = device_postings(inv, q_keys.device)
    wide = _wide_weights_needed(inv, S)
    kw = _kernel_args(inv, max_run, run_offset, wide)

    def run(cap: int, e):
        return inverted_sparse_hits(dp, q_keys, q_valid, None, capacity=cap, expand_e=e, **kw)

    return _launch(
        run, inv, (Q, S, run_offset, capacity), capacity, _expand_budget(inv, Q, S, max_run),
        retry_on_overflow, Q, S, max_run, wide,
    )


def _sparse_finish(inv, st: dict) -> SparseHits:
    """Wait for one launched invocation, fetch and assemble its hit list;
    the rare undersized-E and overflow retries run synchronously."""
    run = st["run"]
    stats, *opt = _finish_fetch(st["fetch"])
    bufs, hv = st["buffers"], st["hv"]
    capacity, expand_e = st["capacity"], st["expand_e"]
    Qn, Sn, max_run, wide = st["Qn"], st["Sn"], st["max_run"], st["wide"]
    n, m = (int(v) for v in stats)
    if expand_e is not None and m > expand_e:
        # the compact budget was too small: retry at the exact total
        expand_e = max(128, min(_qpow2(m), _qpow2(Qn * Sn * max_run)))
        bufs = run(capacity, expand_e)
        n, m = (int(v) for v in _fetch_now([bufs[4]])[0])
        opt = None
    if expand_e is not None:
        _note_expand(inv, Qn, Sn, m)
    if st["retry_on_overflow"] and n > capacity:
        capacity = ((n + 127) // 128) * 128
        bufs = run(capacity, expand_e)
        n = int(_fetch_now([bufs[4]])[0][0])
        opt = None
    h = min(n, capacity)
    hp = _trim_len(h, capacity)
    _note_hp(inv, st["shape_key"], hp)
    if opt and h <= hv:
        return _mk_hits(opt, h, n, wide)
    return _mk_hits(_fetch_now(_hit_views(bufs, hp)), h, n, wide)


def _sparse_single(inv, q_keys, q_valid, capacity: Optional[int], max_run: int, run_offset: int = 0) -> SparseHits:
    """One kernel invocation (+ the retries)."""
    return _sparse_finish(inv, _sparse_launch(inv, q_keys, q_valid, capacity, max_run, run_offset))


def _dp_hits(dp, q_keys, q_valid, *, wide: bool, max_run: int, **kw) -> SparseHits:
    """Every hit pair of one block against the postings ``dp`` (a
    hash-range shard's slice), with no learned hints: compact expansion
    at 4·Q·S slots and auto capacity, retried exactly as needed. ``kw``
    as ``inverted_sparse_hits``' (``n_targets``, ``span_steps``,
    ``run_offset``, ``true_max_run``, …)."""
    Q, S = (int(x) for x in q_keys.shape)
    capacity = max(((min(Q * S * max_run, 4 * 1024 * 1024) + 127) // 128) * 128, 128)
    expand_e = max(128, min(_qpow2(4 * Q * S), _qpow2(Q * S * max_run)))

    def run(cap: int, e):
        return inverted_sparse_hits(
            dp, q_keys, q_valid, None, capacity=cap, expand_e=e, max_run=max_run, wide_weights=wide, **kw
        )

    return _sparse_finish(None, _launch(run, None, None, capacity, expand_e, True, Q, S, max_run, wide))


# total output slots of one chunked launch (C · capacity)
_SCAN_SLOT_BUDGET = 8 * 1024 * 1024
# per-chunk auto-capacity floor (tests lower it to reach the overflow retry)
_CHUNK_CAP_FLOOR = 256 * 1024


def _sparse_chunks(inv, q_keys3, q_valid3, capacity: Optional[int], max_run: int, run_offset: int = 0) -> list:
    """One launch over ``(C, Qc, S)`` query chunks → per-chunk hits.

    The host reads the ``(C, 2)`` stats once and fetches every chunk's
    trimmed buffers together. A chunk whose auto capacity overflowed is
    re-run alone at its exact count; an explicit capacity too large for
    the ``_SCAN_SLOT_BUDGET`` runs the chunks one call each."""
    C, Qc, S = (int(x) for x in q_keys3.shape)
    retry_on_overflow = capacity is None
    cap = capacity
    if cap is None:
        cap = min(Qc * S * max_run, max(_CHUNK_CAP_FLOOR, _SCAN_SLOT_BUDGET // C))
    elif C * cap > _SCAN_SLOT_BUDGET:
        return [
            _sparse_single(inv, q_keys3[c], q_valid3[c], capacity=cap, max_run=max_run, run_offset=run_offset)
            for c in range(C)
        ]
    cap = max(((cap + 127) // 128) * 128, 128)
    dp = device_postings(inv, q_keys3.device)
    expand_e = _expand_budget(inv, Qc, S, max_run)
    wide = _wide_weights_needed(inv, S)
    kw = _kernel_args(inv, max_run, run_offset, wide)

    def run(e):
        return inverted_sparse_hits_chunks(dp, q_keys3, q_valid3, None, capacity=cap, expand_e=e, **kw)

    bufs = run(expand_e)
    shape_key = (C, Qc, S, run_offset, cap)
    hv = _hp_hint(inv, shape_key)
    if hv is not None:
        hv = min(int(hv), cap)
    nm, *opt = _finish_fetch(_start_fetch([bufs[4]] + (_hit_views(bufs, hv) if hv is not None else [])))
    if expand_e is not None and int(nm[:, 1].max()) > expand_e:
        expand_e = max(128, min(_qpow2(int(nm[:, 1].max())), _qpow2(Qc * S * max_run)))
        bufs = run(expand_e)
        nm = _fetch_now([bufs[4]])[0]
        opt = None
    _note_expand(inv, Qc, S, int(nm[:, 1].max()))
    n = nm[:, 0].astype(np.int64)
    hs = np.minimum(n, cap)
    hp = _trim_len(int(hs.max()), cap)
    _note_hp(inv, shape_key, hp)
    views = opt if opt and int(hs.max()) <= hv else _fetch_now(_hit_views(bufs, hp))
    parts = []
    for c in range(C):
        nc, h = int(n[c]), int(hs[c])
        if retry_on_overflow and nc > cap:
            parts.append(
                _sparse_single(inv, q_keys3[c], q_valid3[c], capacity=nc, max_run=max_run, run_offset=run_offset)
            )
            continue
        parts.append(_mk_hits([v[c] for v in views], h, nc, wide))
    return parts


def _trim(h: SparseHits, capacity: Optional[int]) -> SparseHits:
    if capacity is None or h.n_hits <= capacity:
        return h
    return SparseHits(h.q[:capacity], h.t[:capacity], h.count[:capacity], h.weight[:capacity], h.n_hits)


def _merge_partial_hits(parts: list, capacity: Optional[int]) -> SparseHits:
    """Additive merge of run-offset tiles (and of hash-range shards): a
    (q, t) pair may surface in several parts, so lexsort by (q, t),
    segment, and sum; ``capacity`` trims the merged list while
    ``n_hits`` keeps the true pair count."""
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


def _host_u64(x) -> np.ndarray:
    """Query keys (an int64 tensor or array of u64 bits, or uint64) →
    host numpy uint64."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    return x.view(np.uint64) if x.dtype == np.int64 else x.astype(np.uint64)


def sparse_search_host(index, q_keys, q_valid, capacity: Optional[int] = None) -> SparseHits:
    """Host twin of ``sparse_search``: the production host join
    (``core.search._join_tuples``, its cached distinct-hash table and CSR
    expansion) in numpy, same trimmed (q, t)-ascending ``SparseHits``,
    equal bit for bit. A fresh process that just loaded a ``.ksx``
    answers its first blocks here while the device copy of the postings
    uploads (``device_postings``) and the engine warms up
    (``warm_sparse_engine``). ``q_keys``/``q_valid`` may be tensors on
    any device or numpy arrays."""
    inv = _index_inverted(index)
    q64 = _host_u64(q_keys)
    qv = q_valid.detach().cpu().numpy() if isinstance(q_valid, torch.Tensor) else np.asarray(q_valid)
    qv = qv.astype(bool)
    Q = q64.shape[0]
    if inv.n_postings == 0:
        return _empty_hits()
    from ..core.search import _join_tuples

    class _QShim:
        mins = q64[qv]
        offsets = np.concatenate([[0], np.cumsum(qv.sum(axis=1).astype(np.int64))])

        def __len__(self):
            return Q

    q, t, ab, _qhash, _posc = _join_tuples(_QShim(), inv)
    m = len(q)
    if m == 0:
        return _empty_hits()
    q = q.astype(np.int32)
    t = t.astype(np.int32)
    order = np.lexsort((t, q))
    q, t, ab = q[order], t[order], ab[order]
    head = np.empty(m, bool)
    head[0] = True
    head[1:] = (q[1:] != q[:-1]) | (t[1:] != t[:-1])
    starts = np.flatnonzero(head)
    counts = np.diff(np.append(starts, m)).astype(np.int32)
    weights = np.add.reduceat(ab, starts).astype(np.int64)
    return _trim(SparseHits(q[starts], t[starts], counts, weights, len(starts)), capacity)


def _tile(run_chunk: Optional[int], rows: int, S: int) -> int:
    """Run-offset window: ``run_chunk`` (default ``_RUN_TILE``), narrowed
    so that rows·S·window stays int32-safe (narrower tiles only add
    tiles; results are merged additively)."""
    tile = run_chunk if run_chunk is not None else _RUN_TILE
    return max(1, min(tile, (2**31 - 1) // max(rows * S, 1)))


def sparse_search(
    index,
    q_keys: torch.Tensor,
    q_valid: torch.Tensor,
    capacity: Optional[int] = None,
    q_chunk: Optional[int] = None,
    run_chunk: Optional[int] = None,
) -> SparseHits:
    """ProteomeIndex + query block → trimmed (q, t)-ascending hit list, on
    the device of ``q_keys``.

    Args:
      index: anything with an ``inverted`` index (a ``ProteomeIndex``), or
        the CSR arrays ``mins``/``abundances``/``offsets`` to build one on
        the host.
      q_keys: ``(Q, S)`` int64 query hashes (u64 bits); ``q_valid`` the
        ``(Q, S)`` bool mask of real slots.
      capacity: trims the list (``n_hits`` keeps the true count).
      q_chunk: process queries in chunks of this many rows, in one
        chunked launch (the chunk count padded to a power of two with
        all-invalid chunks).
      run_chunk: run-offset tile width (default 2048).
    """
    inv = _index_inverted(index)
    Q, S = (int(x) for x in q_keys.shape)
    if inv.n_postings == 0:
        return _empty_hits()
    q_valid = q_valid.to(torch.bool)
    if q_chunk is not None and Q > q_chunk:
        C = (Q + q_chunk - 1) // q_chunk
        C_pad = 1 << (C - 1).bit_length() if C > 1 else 1
        pad_rows = C_pad * q_chunk - Q
        dev = q_keys.device
        pk = torch.cat([q_keys, torch.full((pad_rows, S), -1, dtype=q_keys.dtype, device=dev)])
        pv = torch.cat([q_valid, torch.zeros((pad_rows, S), dtype=torch.bool, device=dev)])
        pk, pv = pk.view(C_pad, q_chunk, S), pv.view(C_pad, q_chunk, S)
        tile = _tile(run_chunk, q_chunk, S)
        if inv.max_run > tile:
            # one chunked launch per run-offset tile, then a per-chunk
            # additive merge + capacity trim
            tiles = [
                _sparse_chunks(inv, pk, pv, capacity=None, max_run=tile, run_offset=off)
                for off in range(0, inv.max_run, tile)
            ]
            parts = [_merge_partial_hits([t[c] for t in tiles], capacity) for c in range(C)]
        else:
            parts = _sparse_chunks(inv, pk, pv, capacity=capacity, max_run=inv.max_run)[:C]
        return SparseHits(
            np.concatenate([p.q + np.int32(c * q_chunk) for c, p in enumerate(parts)]),
            np.concatenate([p.t for p in parts]),
            np.concatenate([p.count for p in parts]),
            np.concatenate([p.weight for p in parts]),
            sum(p.n_hits for p in parts),
        )
    tile = _tile(run_chunk, Q, S)
    if inv.max_run > tile:
        parts = [
            _sparse_single(inv, q_keys, q_valid, capacity=None, max_run=tile, run_offset=off)
            for off in range(0, inv.max_run, tile)
        ]
        return _merge_partial_hits(parts, capacity)
    return _sparse_single(inv, q_keys, q_valid, capacity=capacity, max_run=inv.max_run)


def sparse_search_stream(
    index,
    blocks,
    capacity: Optional[int] = None,
    q_chunk: Optional[int] = None,
    run_chunk: Optional[int] = None,
):
    """Sparse search over a stream of ``(q_keys, q_valid)`` blocks, with
    one block in flight: block i + 1's kernels are enqueued before block
    i's hit list is read and assembled on the host. Yields one
    ``SparseHits`` a block, in order, each equal to that block's
    ``sparse_search``. Blocks that need query chunking above ``q_chunk``
    or run-offset tiling go through ``sparse_search`` unpipelined."""
    inv = _index_inverted(index)

    class _Shim:
        pass

    shim = _Shim()
    shim.inverted = inv
    pending = None
    for q_keys, q_valid in blocks:
        Q, S = (int(x) for x in q_keys.shape)
        simple = (
            inv.n_postings > 0
            and (q_chunk is None or Q <= q_chunk)
            and inv.max_run <= _tile(run_chunk, Q, S)
        )
        if not simple:
            if pending is not None:
                yield _sparse_finish(inv, pending)
                pending = None
            yield sparse_search(shim, q_keys, q_valid, capacity=capacity, q_chunk=q_chunk, run_chunk=run_chunk)
            continue
        st = _sparse_launch(inv, q_keys, q_valid.to(torch.bool), capacity, inv.max_run)
        if pending is not None:
            yield _sparse_finish(inv, pending)
        pending = st
    if pending is not None:
        yield _sparse_finish(inv, pending)


def warm_sparse_engine(index, q_shape: tuple, q_chunk: Optional[int] = None, device=None) -> bool:
    """Upload the postings (``device_postings``) and run the engine once
    at a serving block shape, on an all-invalid dummy block (zero hits),
    so that the first real block pays neither the upload nor the
    allocator's and the pinned host buffers' first use. The dummy takes
    the production route (learned E, default capacity); hint learning is
    suppressed for it, since its zero matches would shrink the learned
    budgets. ``device`` defaults to the index's, else CUDA. True when the
    dummy gave the expected empty hit list."""
    Q, S = q_shape
    dev = resolve_device(device if device is not None else getattr(index, "device", None))
    q_keys = torch.full((Q, S), -1, dtype=torch.int64, device=dev)
    q_valid = torch.zeros((Q, S), dtype=torch.bool, device=dev)
    _warming_state.active = True
    try:
        hits = sparse_search(index, q_keys, q_valid, q_chunk=q_chunk)
    finally:
        _warming_state.active = False
    return hits.n_hits == 0
