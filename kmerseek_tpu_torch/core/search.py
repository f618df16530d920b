"""Sketch-vs-sketch search: manysearch / multisearch statistics
(counterpart of ``kmerseek_tpu/core/search.py``).

The intersection is a vectorized host join through the target's
inverted postings; the columns are assembled on host in f64,
byte-for-byte as the JAX package writes them. The join is cross-checked
against the device's sparse hit-list engine (``ops.sparse_search``) on
the index's device (``_validate_with_device``); the dense ``(Q, T)``
engine (``_device_pair_stats`` over ``ops.inverted.inverted_search``)
is the oracle that tests and sharded search compare against.

Column contracts (exact):

* manysearch — the 22 columns of kmerseek's golden CSV. Abundance stats
  are the *target* abundances over the intersection;
  ``total_weighted_hashes`` is the target's total abundance.
* multisearch — 16 columns, with

    prob_overlap        = Σ_{h∈I} (q_ab(h)/Σ_q ab) · (db_ab(h)/Σ_db ab)
    prob_overlap_adjusted = prob_overlap · n_queries · n_targets
    containment_adjusted  = containment / prob_overlap_adjusted
    tf_idf_score        = Σ_{h∈I} (q_ab(h)/Σ_q ab) · (1 + ln((1+N)/(1+df(h))))

  (N = number of target sketches, df = how many target sketches contain
  h, db_ab = summed abundance of h across targets), each sum taken over
  the intersection in ascending hash order.

ANI columns follow sourmash: containment^(1/minhash_ksize) with
minhash_ksize = 3·protein_k.

The file-level entry points (``do_manysearch``, ``do_multisearch``) run
their device stages on the CUDA device unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import csv
import gc
import io
import math
import os
import sys
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..ops.inverted import BUCKET_BITS
from .index import ProteomeIndex
from .signature import minhash_ksize

MANYSEARCH_COLUMNS = [
    "query_name",
    "query_md5",
    "match_name",
    "containment",
    "intersect_hashes",
    "ksize",
    "scaled",
    "moltype",
    "match_md5",
    "jaccard",
    "max_containment",
    "average_abund",
    "median_abund",
    "std_abund",
    "query_containment_ani",
    "match_containment_ani",
    "average_containment_ani",
    "max_containment_ani",
    "n_weighted_found",
    "total_weighted_hashes",
    "containment_target_in_query",
    "f_weighted_target_in_query",
]

MULTISEARCH_COLUMNS = [
    "query_name",
    "query_md5",
    "match_name",
    "match_md5",
    "containment",
    "max_containment",
    "jaccard",
    "intersect_hashes",
    "ksize",
    "scaled",
    "moltype",
    "prob_overlap",
    "prob_overlap_adjusted",
    "containment_adjusted",
    "containment_adjusted_log10",
    "tf_idf_score",
]


def _device_pair_stats(query: ProteomeIndex, target: ProteomeIndex):
    """``(Q, T)`` int32 intersect counts and target-weighted sums from the
    dense inverted engine (``ops.inverted.inverted_search``) on
    ``target.device``, as numpy arrays.

    The dense reference engine: production validation runs the sparse
    hit-list engine (``_validate_with_device``), which never fetches a
    ``(Q, T)`` matrix; this one is what the engine-equality tests and
    sharded search are held against."""
    from ..ops.inverted import inverted_search

    q_keys, q_valid = query.dense_device_keys()
    counts, weights = inverted_search(
        target, q_keys.to(target.device), q_valid.to(target.device)
    )
    return counts.cpu().numpy(), weights.cpu().numpy()


class _DbHashStats:
    """Per-index database hash statistics off the sorted posting array.

    Run-length boundaries of the globally sorted postings give, for
    each DISTINCT hash: its first posting index (``run_starts``), its
    document frequency (``df`` — how many targets contain it), and its
    summed abundance (``db_ab``, f64). Computed once per index and
    cached (weak-keyed on the posting array), so every query block
    reuses it."""

    __slots__ = (
        "hashes", "run_starts", "df", "db_ab", "sum_db_ab",
        "_dstarts", "_dshift", "_dsteps",
    )

    def __init__(self, g: np.ndarray, ab: np.ndarray, g_hi: np.ndarray):
        first = np.empty(len(g), bool)
        first[0] = True
        first[1:] = g[1:] != g[:-1]
        self.run_starts = np.flatnonzero(first)
        self.hashes = g[self.run_starts]
        self.df = np.diff(np.append(self.run_starts, len(g)))
        self.db_ab = np.add.reduceat(ab.astype(np.float64), self.run_starts)
        self.sum_db_ab = float(self.db_ab.sum())
        # top-bits bucket table over the DISTINCT hashes (same adaptive
        # shift as ops.inverted.with_buckets): a probe binary-searches
        # only its bucket span instead of the whole table
        nd = len(self.hashes)
        if nd:
            max_hash = int(self.hashes[-1])
            lead_z = 64 - max_hash.bit_length() if max_hash else 0
            self._dshift = max(64 - BUCKET_BITS - lead_z, 32)
            # the shift is >= 32: the high u32 word alone gives the id
            tops = (
                g_hi[self.run_starts] >> np.uint32(self._dshift - 32)
            ).astype(np.int64)
            counts = np.bincount(tops, minlength=1 << BUCKET_BITS)
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            self._dstarts = np.append(starts, nd).astype(np.int64)
            max_span = int(np.diff(self._dstarts).max(initial=1))
            self._dsteps = max(max_span.bit_length(), 1)
        else:
            self._dstarts = np.zeros(2, np.int64)
            self._dshift = 32
            self._dsteps = 1

    def lookup(self, qm: np.ndarray) -> np.ndarray:
        """Vectorized ``searchsorted(self.hashes, qm, side="left")`` via
        the bucket table: O(log max_span) bisect rounds within each
        probe's own bucket span."""
        nd = len(self.hashes)
        if nd == 0:
            return np.zeros(len(qm), np.int64)
        # clamp: probes above the table max (query hashes aren't capped
        # by the TARGET's max) fall in the last bucket and bisect to nd.
        # The bucket id comes from the high u32 word (little-endian
        # byte view).
        qm = np.ascontiguousarray(qm)
        qm_hi = qm.view(np.uint32)[1::2]
        b = np.minimum(
            (qm_hi >> np.uint32(self._dshift - 32)).astype(np.int64),
            len(self._dstarts) - 2,
        )
        lo = self._dstarts[b]
        hi = self._dstarts[b + 1]
        h = self.hashes
        top = nd - 1
        for _ in range(self._dsteps):
            mid = (lo + hi) >> 1
            go_right = (h[np.minimum(mid, top)] < qm) & (mid < hi)
            lo = np.where(go_right, mid + 1, lo)
            hi = np.where(go_right, hi, mid)
        return lo


_DB_STATS_CACHE: "OrderedDict[int, tuple]" = OrderedDict()
_DB_STATS_SLOTS = 4


def _db_hash_stats(inv) -> _DbHashStats:
    """Cached per index, weak-keyed on the posting array ``g_hi``."""
    owner = inv.g_hi
    ent = _DB_STATS_CACHE.get(id(owner))
    if ent is not None and ent[0]() is owner:
        _DB_STATS_CACHE.move_to_end(id(owner))
        return ent[1]
    stats = _DbHashStats(inv.g64(), inv.ab, g_hi=inv.g_hi)
    _DB_STATS_CACHE[id(owner)] = (weakref.ref(owner), stats)
    while len(_DB_STATS_CACHE) > _DB_STATS_SLOTS:
        _DB_STATS_CACHE.popitem(last=False)
    return stats


class _JoinSegments:
    """Sparse (query, target) hit segments of the flat intersection join.

    One ``searchsorted`` of every query hash into the target's distinct
    database hashes expands to (q_row, target, abundance) tuples —
    one per query-hash/target co-occurrence — which, sorted by
    (q_row, target, <inner>), form contiguous segments: exactly the
    hit pairs with ≥1 shared hash. All per-pair statistics then fall out
    of segmented reductions (``np.add.reduceat``)."""

    __slots__ = (
        "starts", "seg_n", "seg_q", "seg_t", "seg_id",
        "pab", "qhash", "qpos", "total",
    )

    def __init__(
        self, starts, seg_n, seg_q, seg_t, seg_id, pab, qhash, qpos, total
    ):
        self.starts = starts
        self.seg_n = seg_n
        self.seg_q = seg_q
        self.seg_t = seg_t
        self.seg_id = seg_id
        self.pab = pab
        self.qhash = qhash
        self.qpos = qpos  # (len(query.mins),) distinct-hash index per query hash
        self.total = total


def _join_tuples(query: ProteomeIndex, inv):
    """Flat, unsorted co-occurrence tuples of the intersection join.

    One probe of every query hash into ``inv``'s distinct-hash table,
    expanded to one (q_row, target, abundance, q_hash_index) tuple per
    query-hash/target co-occurrence."""
    st = _db_hash_stats(inv)
    qm = query.mins
    # one searchsorted into the distinct-hash table; run start and
    # document frequency come from the cached run table
    nd = len(st.hashes)
    pos = st.lookup(qm)  # bucketed searchsorted (see _DbHashStats)
    posc = np.minimum(pos, max(nd - 1, 0))
    found = (pos < nd) & (st.hashes[posc] == qm) if nd else np.zeros(len(qm), bool)
    cnt = np.where(found, st.df[posc], 0).astype(np.int64)
    lo = np.where(found, st.run_starts[posc], 0)
    total = int(cnt.sum())
    if total == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z, posc
    q_sizes = np.diff(query.offsets)
    q_row_per_hash = np.repeat(np.arange(len(query), dtype=np.int64), q_sizes)
    # expand each query hash's posting span [lo, hi) into flat indices
    base = np.repeat(cnt.cumsum() - cnt, cnt)
    idx = np.arange(total, dtype=np.int64) - base + np.repeat(lo, cnt)
    pq = np.repeat(q_row_per_hash, cnt)
    pt = inv.tid[idx].astype(np.int64)
    pab = inv.ab[idx].astype(np.int64)
    qhash = np.repeat(np.arange(len(qm), dtype=np.int64), cnt)
    return pq, pt, pab, qhash, posc


def _segments_from_tuples(
    pq, pt, pab, qhash, qm, nq: int, T: int, inner: str, qpos
) -> _JoinSegments:
    """Sort flat tuples into contiguous (q, t) segments.

    ``inner`` picks the within-segment tuple order (see ``_host_join``).
    The sort key totally orders everything downstream consumes (equal
    keys are interchangeable), so the result does not depend on the
    order of the input tuples."""
    total = len(pq)
    if total == 0:
        z = np.zeros(0, np.int64)
        return _JoinSegments(z, z, z, z, z, z, z, qpos, 0)
    if inner == "ab" and nq * T < 2**32:
        # one packed int64 key: (pq, pt) fits 32 bits by the guard, pab
        # fits 31 (postings are int32 abundances)
        key = (pq * np.int64(T) + pt) * np.int64(1 << 31) + pab
        order = np.argsort(key, kind="stable")
    elif inner == "hash" and nq * T * max(len(qm), 1) < 2**62:
        # qhash is an index into query.mins, which is sorted ascending
        # (and distinct) within each query row — so within a (pq, pt)
        # segment, qhash order IS hash-value order, and (pq, pt, qhash)
        # is a unique total key (a hash occurs at most once per target's
        # sketch)
        key = (pq * np.int64(T) + pt) * np.int64(max(len(qm), 1)) + qhash
        order = np.argsort(key, kind="stable")
    else:
        inner_key = pab if inner == "ab" else qm[qhash]
        order = np.lexsort((inner_key, pt, pq))
    pq, pt, pab, qhash = pq[order], pt[order], pab[order], qhash[order]
    new = np.empty(total, bool)
    new[0] = True
    new[1:] = (pq[1:] != pq[:-1]) | (pt[1:] != pt[:-1])
    starts = np.flatnonzero(new)
    seg_n = np.diff(np.append(starts, total))
    seg_id = np.cumsum(new) - 1
    return _JoinSegments(
        starts, seg_n, pq[starts], pt[starts], seg_id, pab, qhash, qpos, total
    )


def _host_join(query: ProteomeIndex, target: ProteomeIndex, inner: str) -> _JoinSegments:
    """Vectorized intersection join via the target's inverted index.

    ``inner`` picks the within-segment tuple order: ``"ab"`` (ascending
    target abundance — enables O(1) segmented medians) or ``"hash"``
    (ascending hash value — the per-hash summation order of the
    multisearch probability scores)."""
    pq, pt, pab, qhash, posc = _join_tuples(query, target.inverted)
    return _segments_from_tuples(
        pq, pt, pab, qhash, query.mins, len(query), len(target), inner, posc
    )


# per-(query, target) validated-block counters (weak-keyed: retired
# corpora must not be kept alive by a bookkeeping cache)
_VALIDATE_COUNTS: "OrderedDict[tuple, tuple]" = OrderedDict()
_VALIDATE_SLOTS = 64
# full cross-check on a pair's first blocks, then every Nth
_VALIDATE_WARMUP = 2
_VALIDATE_EVERY = 16


def _validation_due(query, target) -> bool:
    key = (id(query.mins), id(target.mins))
    ent = _VALIDATE_COUNTS.get(key)
    if ent is None or ent[0]() is not query.mins or ent[1]() is not target.mins:
        n = 0
    else:
        n = ent[2]
    _VALIDATE_COUNTS[key] = (
        weakref.ref(query.mins), weakref.ref(target.mins), n + 1,
    )
    _VALIDATE_COUNTS.move_to_end(key)
    while len(_VALIDATE_COUNTS) > _VALIDATE_SLOTS:
        _VALIDATE_COUNTS.popitem(last=False)
    return n < _VALIDATE_WARMUP or (n % _VALIDATE_EVERY) == 0


def _validate_with_device(query, target, js: _JoinSegments, weighted, sample: int = 64):
    """Cross-check the host join against the device's sparse hit-list
    engine (``ops.sparse_search``) on ``target.device``.

    The hit list is exactly the host join's segment list, so the
    structural check is full (every pair's (q, t, count)); weighted sums
    are compared on a seeded sample. Raises on disagreement.

    Amortized: a (query, target) pair's first two blocks and every 16th
    after. ``KMERSEEK_SEARCH_VALIDATE``: ``0`` never, ``always`` every
    call. Each run adds one to ``_validate_with_device.runs``."""
    policy = os.environ.get("KMERSEEK_SEARCH_VALIDATE", "")
    if policy == "0":
        return
    if policy != "always" and not _validation_due(query, target):
        return
    rng = np.random.default_rng(0)
    take = rng.choice(len(js.seg_n), size=min(sample, len(js.seg_n)), replace=False)

    from ..ops.sparse_search import sparse_search

    q_keys, q_valid = query.dense_device_keys()
    hits = sparse_search(
        target,
        q_keys.to(target.device),
        q_valid.to(target.device),
        capacity=len(js.seg_n) + 128,
        q_chunk=4096,  # bounds the tuple expansion
    )
    _validate_with_device.runs += 1
    if hits.n_hits != len(js.seg_n):
        raise RuntimeError(
            "device/host search disagreement: sparse engine found "
            f"{hits.n_hits} hit pairs, host join found {len(js.seg_n)}"
        )
    # both sides are (q, t)-ascending → direct array comparison
    count_ok = (
        np.array_equal(hits.q, js.seg_q)
        and np.array_equal(hits.t, js.seg_t)
        and np.array_equal(hits.count, js.seg_n)
    )
    if not count_ok:
        raise RuntimeError("device/host search disagreement on intersect counts")
    if not np.array_equal(hits.weight[take], weighted[take]):
        raise RuntimeError(
            "device/host search disagreement on sampled weighted sums"
        )


_validate_with_device.runs = 0


def _ani(containment: float, k3: int) -> float:
    if containment <= 0.0:
        return 0.0
    return math.exp(math.log(containment) / k3)


def manysearch(
    query: ProteomeIndex,
    target: ProteomeIndex,
    threshold: float = 0.0,
) -> List[Dict]:
    """All query × target rows with ≥1 shared hash (threshold 0 default,
    matching the CLI's 'show all matches' behavior)."""
    return _rows_from_columns(manysearch_columns(query, target, threshold))


def manysearch_columns(
    query: ProteomeIndex,
    target: ProteomeIndex,
    threshold: float = 0.0,
) -> Dict[str, list]:
    """Column-native manysearch: {column: list} in MANYSEARCH_COLUMNS
    order, bit-identical values to the dict rows; no per-row dict
    construction, and ``write_search_csv_columns`` formats per column."""
    if (query.config.ksize, query.config.scaled, query.config.moltype) != (
        target.config.ksize,
        target.config.scaled,
        target.config.moltype,
    ):
        raise ValueError("query/target sketch parameters differ")
    js = _host_join(query, target, inner="ab")
    if js.total == 0:
        return {c: [] for c in MANYSEARCH_COLUMNS}
    t_sizes = np.diff(target.offsets)
    t_weight = np.add.reduceat(
        np.append(target.abundances, 0), target.offsets[:-1]
    ) * (t_sizes > 0)
    return _assemble_manysearch_columns(
        query, target, js, threshold, t_sizes, t_weight,
        validate=lambda weighted: _validate_with_device(
            query, target, js, weighted
        ),
    )


def _assemble_manysearch_columns(
    query,
    target,
    js: _JoinSegments,
    threshold: float,
    t_sizes: np.ndarray,
    t_weight: np.ndarray,
    validate=None,
) -> Dict[str, list]:
    """Segments → the 22 manysearch columns.

    ``validate`` (if given) is called with the segmented weighted sums
    before assembly (the device cross-check hook)."""
    k3 = minhash_ksize(query.config.ksize)
    scaled = query.config.scaled
    moltype = query.config.moltype
    q_sizes = np.diff(query.offsets)

    # segmented statistics over the target abundances of each pair's
    # intersection (tuples within a segment are sorted by abundance)
    weighted = np.add.reduceat(js.pab, js.starts)  # int64 — no overflow
    if validate is not None:
        validate(weighted)
    mean = weighted / js.seg_n
    dev = js.pab.astype(np.float64) - mean[js.seg_id]
    std = np.sqrt(np.add.reduceat(dev * dev, js.starts) / js.seg_n)
    mid_lo = js.starts + (js.seg_n - 1) // 2
    mid_hi = js.starts + js.seg_n // 2
    median = (js.pab[mid_lo] + js.pab[mid_hi]) / 2.0

    qs = q_sizes[js.seg_q]
    ts = t_sizes[js.seg_t]
    containment = js.seg_n / qs
    keep = containment >= threshold
    c_tq = js.seg_n / ts
    jaccard = js.seg_n / (qs + ts - js.seg_n)
    tw = t_weight[js.seg_t]
    f_weighted = weighted / tw

    # emit in (query_name, match_name) order without a Python sort;
    # cached dense name ranks make this an integer lexsort (stable on
    # both sides, so duplicate names keep the string sort's row order)
    kept = np.flatnonzero(keep)
    # single packed sort key: both rank spaces are dense (< len(index)),
    # so qrank * n_tranks + trank fits int64 comfortably
    n_tranks = np.int64(len(target)) + 1
    kept = kept[
        np.argsort(
            query.name_ranks[js.seg_q[kept]] * n_tranks
            + target.name_ranks[js.seg_t[kept]],
            kind="stable",
        )
    ]

    # vectorized column assembly: numeric columns stay numpy arrays
    # (the CSV formatter round-trips through .tolist() → repr), string
    # columns come from object-array fancy indexing
    sq = js.seg_q[kept]
    st = js.seg_t[kept]
    cont = containment[kept]
    ctq = c_tq[kept]
    n = len(sq)
    # scalar libm exp/log — keeps the golden CSV strings bit-exact
    # (numpy's SIMD transcendentals can differ in the last ulp); the
    # distinct containment values are few (count/size rationals), so
    # compute each once and scatter by inverse index
    u, inv_idx = np.unique(np.concatenate([cont, ctq]), return_inverse=True)
    ani_u = np.array([_ani(c, k3) for c in u.tolist()], np.float64)
    ani_q = ani_u[inv_idx[:n]]
    ani_t = ani_u[inv_idx[n:]]

    return {
        "query_name": query.names_array[sq].tolist(),
        "query_md5": query.md5_array[sq].tolist(),
        "match_name": target.names_array[st].tolist(),
        "containment": cont,
        "intersect_hashes": js.seg_n[kept],
        "ksize": np.full(n, k3, np.int64),
        "scaled": np.full(n, scaled, np.int64),
        "moltype": [moltype] * n,
        "match_md5": target.md5_array[st].tolist(),
        "jaccard": jaccard[kept],
        "max_containment": np.maximum(cont, ctq),
        "average_abund": mean[kept],
        "median_abund": median[kept],
        "std_abund": std[kept],
        "query_containment_ani": ani_q,
        "match_containment_ani": ani_t,
        "average_containment_ani": (ani_q + ani_t) / 2.0,
        "max_containment_ani": np.maximum(ani_q, ani_t),
        "n_weighted_found": weighted[kept],
        "total_weighted_hashes": tw[kept],
        "containment_target_in_query": ctq,
        "f_weighted_target_in_query": f_weighted[kept],
    }


def multisearch(
    query: ProteomeIndex,
    target: ProteomeIndex,
    threshold: float = 0.0,
    estimate_prob_overlap: bool = True,
) -> List[Dict]:
    """Pairwise scoring with database-frequency statistics (the
    ``do_multisearch`` variant)."""
    return _rows_from_columns(
        multisearch_columns(query, target, threshold, estimate_prob_overlap)
    )


def multisearch_columns(
    query: ProteomeIndex,
    target: ProteomeIndex,
    threshold: float = 0.0,
    estimate_prob_overlap: bool = True,
) -> Dict[str, list]:
    """Column-native multisearch (see ``manysearch_columns``)."""
    k3 = minhash_ksize(query.config.ksize)
    n_targets = len(target)
    n_comparisons = float(len(query) * n_targets)

    # flat join, tuples ordered by hash within each (query, target)
    # segment: the probability terms are summed per ascending hash
    js = _host_join(query, target, inner="hash")
    if js.total == 0:
        cols = MULTISEARCH_COLUMNS if estimate_prob_overlap else MULTISEARCH_COLUMNS[:11]
        return {c: [] for c in cols}

    # per-hash document frequency + summed abundance, cached per index
    # (``_db_hash_stats``) and shared with the join
    st_db = _db_hash_stats(target.inverted)
    df_arr = st_db.df
    db_ab_arr = st_db.db_ab
    sum_db_ab = st_db.sum_db_ab
    weighted = np.add.reduceat(js.pab, js.starts)
    _validate_with_device(query, target, js, weighted)

    q_sizes = np.diff(query.offsets)
    t_sizes = np.diff(target.offsets)
    sum_q_ab = np.add.reduceat(
        np.append(query.abundances, 0), query.offsets[:-1]
    ).astype(np.float64)

    # per-tuple tf / probability / tf-idf terms, reduced per segment on
    # the host in f64, in tuple order (any other order changes the last
    # bits); the distinct-hash position of every query hash is already
    # known from the join probe
    dbpos = js.qpos[js.qhash]
    tf = query.abundances[js.qhash].astype(np.float64) / sum_q_ab[js.seg_q[js.seg_id]]
    prob = np.add.reduceat(tf * (db_ab_arr[dbpos] / sum_db_ab), js.starts)
    tfidf = np.add.reduceat(
        tf * (1.0 + np.log((1.0 + n_targets) / (1.0 + df_arr[dbpos]))), js.starts
    )

    qs = q_sizes[js.seg_q]
    ts = t_sizes[js.seg_t]
    containment = js.seg_n / qs
    keep = containment >= threshold
    c_tq = js.seg_n / ts
    jaccard = js.seg_n / (qs + ts - js.seg_n)

    return _assemble_multisearch_columns(
        query, target, js.seg_q, js.seg_t, js.seg_n,
        containment, c_tq, jaccard, prob, tfidf, keep,
        k3, n_comparisons, estimate_prob_overlap,
    )


def _assemble_multisearch_columns(
    query,
    target,
    seg_q: np.ndarray,
    seg_t: np.ndarray,
    seg_n: np.ndarray,
    containment: np.ndarray,
    c_tq: np.ndarray,
    jaccard: np.ndarray,
    prob: np.ndarray,
    tfidf: np.ndarray,
    keep: np.ndarray,
    k3: int,
    n_comparisons: float,
    estimate_prob_overlap: bool,
) -> Dict[str, list]:
    """Per-pair statistics → the 16 multisearch columns (the first 11
    without ``estimate_prob_overlap``).

    Emit order and column assembly mirror
    ``_assemble_manysearch_columns``. ``target`` only needs the metadata
    surface (``__len__``, ``names_array``, ``md5_array``,
    ``name_ranks``)."""
    kept = np.flatnonzero(keep)
    n_tranks = np.int64(len(target)) + 1
    kept = kept[
        np.argsort(
            query.name_ranks[seg_q[kept]] * n_tranks
            + target.name_ranks[seg_t[kept]],
            kind="stable",
        )
    ]

    sq = seg_q[kept]
    st = seg_t[kept]
    cont = containment[kept]
    n = len(sq)
    scaled = query.config.scaled
    moltype = query.config.moltype
    cols = {
        "query_name": query.names_array[sq].tolist(),
        "query_md5": query.md5_array[sq].tolist(),
        "match_name": target.names_array[st].tolist(),
        "match_md5": target.md5_array[st].tolist(),
        "containment": cont,
        "max_containment": np.maximum(cont, c_tq[kept]),
        "jaccard": jaccard[kept],
        "intersect_hashes": seg_n[kept].astype(np.float64),
        "ksize": np.full(n, k3, np.int64),
        "scaled": np.full(n, scaled, np.int64),
        "moltype": [moltype] * n,
    }
    if not estimate_prob_overlap:
        return cols
    prob_k = prob[kept]
    pa = prob_k * n_comparisons
    with np.errstate(divide="ignore", invalid="ignore"):
        ca = np.where(pa != 0.0, cont / pa, 0.0)
    cols["prob_overlap"] = prob_k
    cols["prob_overlap_adjusted"] = pa
    cols["containment_adjusted"] = ca
    # scalar libm log10 per row on purpose: numpy's SIMD transcendental
    # can differ in the last ulp
    cols["containment_adjusted_log10"] = np.array(
        [
            math.log10(r) if r > 0.0 else 0.0
            for r in np.where(cont > 0.0, ca, 0.0).tolist()
        ],
        np.float64,
    )
    cols["tf_idf_score"] = tfidf[kept]
    return cols


def _as_index(obj, ksize=None, scaled=None, moltype=None, device=None) -> ProteomeIndex:
    """Accept a ProteomeIndex, a .sig.zip path, or an entity with a
    ``.sig`` product path.

    Like branchwater, sketches are *selected* by the requested
    (ksize, scaled, moltype) — an archive may carry several parameter
    sets; only matching signatures participate. Raises when the
    selection is empty (parameter mismatch) or spans several parameter
    sets. An index made here runs its device stages on ``device``
    (default: the CUDA device); a ProteomeIndex keeps its own."""
    if isinstance(obj, ProteomeIndex):
        _check_requested_params(obj, ksize, scaled, moltype)
        return obj
    if hasattr(obj, "sig"):
        obj = obj.sig
    from .sigzip import read_sig_zip

    sigs = read_sig_zip(str(obj))
    selected = [
        s
        for s in sigs
        if (ksize is None or s.ksize == ksize)
        and (scaled is None or s.scaled == scaled)
        and (moltype is None or s.moltype == moltype)
    ]
    if not selected:
        have = sorted({(s.moltype, s.ksize, s.scaled) for s in sigs})
        raise ValueError(
            f"no signatures in {obj} match "
            f"(moltype={moltype}, ksize={ksize}, scaled={scaled}); "
            f"archive has {have}"
        )
    params = sorted({(s.moltype, s.ksize, s.scaled) for s in selected})
    if len(params) > 1:
        raise ValueError(
            f"{obj} holds signatures with several sketch parameter sets "
            f"{params}; pass explicit moltype/ksize/scaled to select one"
        )
    return ProteomeIndex.from_signatures(selected, device=device)


def do_manysearch(
    query, target, output, ksize=None, scaled=None, moltype=None, *, device=None
):
    """File-level manysearch: query/target .sig.zip (or entities) → CSV
    (parquet for a ``.parquet``/``.pq`` output).

    Argument order mirrors kmerseek's ``do_manysearch(query, target,
    output, ksize, scaled, moltype)``; threshold is 0 to show all
    matches, even with only 1 k-mer. Signatures are selected from the
    archives by the requested parameters (branchwater semantics).
    ``device``: where the device stages run (default: the CUDA device;
    without one this raises unless ``device="cpu"``)."""
    q = _as_index(query, ksize, scaled, moltype, device)
    t = _as_index(target, ksize, scaled, moltype, device)
    cols = manysearch_columns(q, t, threshold=0.0)
    _write_output(cols, output)
    return _rows_from_columns(cols)


def do_multisearch(
    query, target, output, moltype=None, ksize=None, scaled=None, *, device=None
):
    """File-level multisearch with probability-of-overlap scoring.

    Mirrors kmerseek's ``do_multisearch(query, target, output, moltype,
    ksize, scaled)``; threshold 0, prob_overlap estimated. ``device`` as
    for ``do_manysearch``."""
    q = _as_index(query, ksize, scaled, moltype, device)
    t = _as_index(target, ksize, scaled, moltype, device)
    cols = multisearch_columns(q, t, threshold=0.0, estimate_prob_overlap=True)
    _write_output(cols, output)
    return _rows_from_columns(cols)


def _check_requested_params(index: ProteomeIndex, ksize, scaled, moltype):
    got = index.config
    if ksize is not None and ksize != got.ksize:
        raise ValueError(f"requested ksize {ksize}, archive has {got.ksize}")
    if scaled is not None and scaled != got.scaled:
        raise ValueError(f"requested scaled {scaled}, archive has {got.scaled}")
    if moltype is not None and moltype != got.moltype:
        raise ValueError(
            f"requested moltype {moltype}, archive has {got.moltype}"
        )


def _rows_from_columns(cols: Dict[str, list]) -> List[Dict]:
    """{column: list} → list of per-row dicts (same key order).

    GC is paused for the bulk build: creating ~rows×cols container
    objects in one burst otherwise triggers repeated full generational
    collections."""
    keys = list(cols.keys())
    # numpy-backed numeric columns → plain Python scalars first
    vals = [
        v.tolist() if isinstance(v, np.ndarray) else v for v in cols.values()
    ]
    gc_was_enabled = gc.isenabled()
    gc.disable()
    try:
        return [dict(zip(keys, row)) for row in zip(*vals)]
    finally:
        if gc_was_enabled:
            gc.enable()


def _format_value(v) -> str:
    if isinstance(v, float):
        # through the builtin float: repr(np.float64) would prepend the
        # dtype in numpy 2.x while repr(float) is the shortest
        # round-trip string the reference CSV pins
        return repr(float(v))
    return str(v)


def _format_column(vals: list) -> list:
    """One column → CSV cell strings, quoting applied.

    Floats via ``repr`` of the builtin float (shortest round-trip, as
    the rows path writes them). Numeric-derived strings never need
    quoting; string columns get ``csv`` QUOTE_MINIMAL semantics (quote
    if the value holds a delimiter, quote, or newline; embedded quotes
    doubled) — byte-identical to ``csv.writer`` output."""
    if len(vals) == 0:
        return []
    if isinstance(vals, np.ndarray):
        # .tolist() yields builtin scalars
        if vals.dtype.kind == "f":
            return list(map(repr, vals.tolist()))
        return list(map(str, vals.tolist()))
    v0 = vals[0]
    if isinstance(v0, float):
        return list(map(repr, vals))
    if isinstance(v0, str):
        return [
            '"' + s.replace('"', '""') + '"'
            if ('"' in s or "," in s or "\n" in s or "\r" in s)
            else s
            for s in vals
        ]
    return list(map(str, vals))


# rows per write block — bounds peak string memory on huge outputs
_CSV_BLOCK_ROWS = 65536


def write_search_csv_columns(
    cols: Dict[str, list], filename: Optional[str] = None
) -> None:
    """Stream a column-native result ({column: list}) as CSV.

    Formats per *column* (one type dispatch + one ``map`` each), then
    emits blocks of ``",".join``-ed rows in bounded memory; no per-row
    dicts. Byte-identical to ``write_search_csv``."""
    formatted = [_format_column(v) for v in cols.values()]
    n = len(formatted[0]) if formatted else 0

    def _emit(fh):
        fh.write(",".join(cols.keys()) + "\n")
        for lo in range(0, n, _CSV_BLOCK_ROWS):
            rows = zip(*(c[lo:lo + _CSV_BLOCK_ROWS] for c in formatted))
            fh.write("\n".join(",".join(r) for r in rows) + "\n")

    if filename is None:
        _emit(sys.stdout)
        sys.stdout.flush()
    else:
        with open(filename, "w", newline="") as f:
            _emit(f)


def _write_output(cols: Dict[str, list], output: Optional[str]) -> None:
    """File-API output dispatch: ``.parquet``/``.pq`` extensions get the
    binary path, everything else (or stdout) the CSV contract."""
    if output is not None and str(output).endswith((".parquet", ".pq")):
        write_search_parquet(cols, output)
    else:
        write_search_csv_columns(cols, output)


def write_search_parquet(cols: Dict[str, list], filename: str) -> None:
    """Column-native result → parquet: no float-to-text formatting,
    exact binary doubles; read back with pyarrow/pandas."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    pq.write_table(pa.table({k: pa.array(v) for k, v in cols.items()}), filename)


def _write_rows(fh, rows: Sequence[Dict], columns: Sequence[str]) -> None:
    w = csv.writer(fh, lineterminator="\n")
    w.writerow(columns)
    for r in rows:
        w.writerow([_format_value(r[c]) for c in columns])


def rows_to_csv(rows: Sequence[Dict], columns: Sequence[str]) -> str:
    buf = io.StringIO()
    _write_rows(buf, rows, columns)
    return buf.getvalue()


def write_search_csv(
    rows: Sequence[Dict],
    columns: Sequence[str],
    filename: Optional[str] = None,
) -> None:
    """Stream rows to stdout/file — never materializes the whole CSV."""
    if filename is None:
        _write_rows(sys.stdout, rows, columns)
        sys.stdout.flush()
    else:
        with open(filename, "w", newline="") as f:
            _write_rows(f, rows, columns)
