"""Sketch-vs-sketch search: manysearch / multisearch statistics
(counterpart of ``kmerseek_tpu/core/search.py``).

The intersection is a vectorized host join through the target's
inverted postings; the columns are assembled on host in f64,
byte-for-byte as the JAX package writes them. Every join is
cross-checked against the device's sparse hit-list engine
(``ops.sparse_search``) on the index's device (``_validate_with_device``);
the dense ``(Q, T)`` engine (``_device_pair_stats`` over
``ops.inverted.inverted_search``) is the oracle that tests and sharded
search compare against.

A result has one form: its columns ({column: values}, in column order).
``manysearch`` / ``multisearch`` return them as ``SearchRows``, a
sequence of row dicts built only when read; ``result_columns`` is the
one way back to columns, for the CSV writer and the stitch.

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

import collections.abc
import io
import math
import operator
import sys
import weakref
from collections import OrderedDict
from typing import Dict, Optional, Sequence

import numpy as np

from .. import native
from ..ops.inverted import BUCKET_BITS
from ..utils.metrics import count, note_sync, span
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


class SearchRows(collections.abc.Sequence):
    """A search result as a sequence of row dicts, backed by its columns
    (``manysearch_columns`` / ``multisearch_columns``'s {column: values},
    in column order) and holding nothing else.

    ``rows[i]`` builds that row's dict: the columns' keys in order, numpy
    values as the Python scalars ``.tolist()`` gives. Iteration builds
    one dict a row as it goes; a slice is a list of dicts, as a list's
    slice is. Equal to any sequence of dicts with the same rows."""

    __slots__ = ("columns",)
    __hash__ = None

    def __init__(self, columns: Dict[str, Sequence]):
        self.columns = columns

    def __len__(self) -> int:
        return len(next(iter(self.columns.values()), ()))

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        return {k: v[i].item() if isinstance(v, np.ndarray) else v[i] for k, v in self.columns.items()}

    def __iter__(self):
        vals = [v.tolist() if isinstance(v, np.ndarray) else v for v in self.columns.values()]
        return (dict(zip(self.columns, row)) for row in zip(*vals))

    def __eq__(self, other):
        if not isinstance(other, collections.abc.Sequence) or isinstance(other, str):
            return NotImplemented
        return len(self) == len(other) and all(map(operator.eq, self, other))


def result_columns(rows: Sequence[Dict], names: Sequence[str]) -> list:
    """The columns ``names`` of a search result, one sequence of values
    each: a ``SearchRows``'s own columns as they are, any other sequence
    of row dicts transposed once."""
    if not rows:
        return [[] for _ in names]
    if isinstance(rows, SearchRows):
        return [rows.columns[c] for c in names]
    if len(names) == 1:
        return [[r[names[0]] for r in rows]]
    return list(zip(*map(operator.itemgetter(*names), rows)))


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
    note_sync(counts)
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
    query-hash/target co-occurrence (counter ``search.tuples``: their
    number, one count a call)."""
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
    count("search.tuples", total)
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
    multisearch probability scores). Span ``search.join``."""
    with span("search.join"):
        pq, pt, pab, qhash, posc = _join_tuples(query, target.inverted)
        return _segments_from_tuples(
            pq, pt, pab, qhash, query.mins, len(query), len(target), inner, posc
        )


def _validate_with_device(query, target, js: _JoinSegments, weighted, sample: int = 64):
    """Cross-check the host join against the device's sparse hit-list
    engine (``ops.sparse_search``) on ``target.device``, on every call:
    one ``search.cross_check`` span.

    The hit list is exactly the host join's segment list, so the
    structural check is full (every pair's (q, t, count)); weighted sums
    are compared on a seeded sample. Raises on disagreement."""
    with span("search.cross_check"):
        _cross_check(query, target, js, weighted, sample)


def _cross_check(query, target, js: _JoinSegments, weighted, sample: int) -> None:
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


def _ani(containment: float, k3: int) -> float:
    if containment <= 0.0:
        return 0.0
    return math.exp(math.log(containment) / k3)


def manysearch(
    query: ProteomeIndex,
    target: ProteomeIndex,
    threshold: float = 0.0,
) -> SearchRows:
    """All query × target rows with ≥1 shared hash (threshold 0 default,
    matching the CLI's 'show all matches' behavior), as ``SearchRows``
    over ``manysearch_columns``. Span ``search.manysearch`` around its
    spans."""
    with span("search.manysearch"):
        return SearchRows(manysearch_columns(query, target, threshold))


def manysearch_columns(
    query: ProteomeIndex,
    target: ProteomeIndex,
    threshold: float = 0.0,
) -> Dict[str, list]:
    """Column-native manysearch: {column: values} in MANYSEARCH_COLUMNS
    order (numeric columns as numpy arrays, text columns as lists).
    Spans ``search.join`` and ``search.columns`` (the assembly, with
    ``search.cross_check`` inside; counter ``rows``). The target's
    per-target sums are its cached ``t_sizes`` / ``t_weight``."""
    if (query.config.ksize, query.config.scaled, query.config.moltype) != (
        target.config.ksize,
        target.config.scaled,
        target.config.moltype,
    ):
        raise ValueError("query/target sketch parameters differ")
    js = _host_join(query, target, inner="ab")
    if js.total == 0:
        return {c: [] for c in MANYSEARCH_COLUMNS}
    with span("search.columns"):
        return _assemble_manysearch_columns(
            query, target, js, threshold, target.t_sizes, target.t_weight,
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
    count("rows", n)
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
) -> SearchRows:
    """Pairwise scoring with database-frequency statistics (the
    ``do_multisearch`` variant), as ``SearchRows`` over
    ``multisearch_columns``."""
    return SearchRows(multisearch_columns(query, target, threshold, estimate_prob_overlap))


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
    return SearchRows(cols)


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
    return SearchRows(cols)


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


def _format_value(v) -> str:
    if isinstance(v, float):
        # through the builtin float: repr(np.float64) would prepend the
        # dtype in numpy 2.x while repr(float) is the shortest
        # round-trip string the reference CSV pins
        return repr(float(v))
    return str(v)


# a cell holding one of these is quoted (csv QUOTE_MINIMAL with "\n" lines)
_QUOTE_CHARS = (",", '"', "\n", "\r")
_FLOAT_TYPES = frozenset((float, np.float64))
_INT_TYPES = frozenset((int, np.int64))


def _quote(s: str) -> str:
    """One cell as ``csv.writer`` writes it: quoted when it holds a
    delimiter, a quote or a line break, embedded quotes doubled."""
    if any(ch in s for ch in _QUOTE_CHARS):
        return '"' + s.replace('"', '""') + '"'
    return s


def _typed_column(vals):
    """One column → ``(typed, per_value)``, classified once by the exact
    types of its values.

    ``typed`` is a float64 array (a float64 column, or every value a
    ``float`` or ``np.float64``), an int64 array (an int64 column, or
    every value an ``int`` or ``np.int64`` that fits), or a list of
    quoted ``str`` cells. Other numpy columns are classified by their
    ``.tolist()`` values. Anything else (``np.float32`` scalars,
    ``None``, ``bool``, ints beyond int64, mixed columns) goes through
    ``_format_value`` one value at a time, and ``per_value`` is True."""
    if isinstance(vals, np.ndarray):
        if vals.dtype in (np.float64, np.int64):
            return vals, False
        vals = vals.tolist()  # the values a row dict holds
    types = set(map(type, vals))
    if types <= _FLOAT_TYPES:
        return np.fromiter(vals, np.float64, len(vals)), False
    if types <= _INT_TYPES:
        try:
            return np.fromiter(vals, np.int64, len(vals)), False
        except OverflowError:
            pass
    if types == {str}:
        joined = "".join(vals)
        if not any(ch in joined for ch in _QUOTE_CHARS):
            return vals, False
        return [_quote(v) for v in vals], False
    return [_quote(_format_value(v)) for v in vals], True


def _format_column(col) -> list:
    """A typed column → its cells in Python: ``repr`` of each float
    (shortest round-trip), ``str`` of each int; text cells as they are.
    What ``native.format_csv`` writes, for a host without the library."""
    if isinstance(col, np.ndarray):
        # .tolist() yields builtin scalars
        return list(map(repr if col.dtype == np.float64 else str, col.tolist()))
    return col


# rows per write block — bounds peak string memory on huge outputs
_CSV_BLOCK_ROWS = 65536


def _write_csv(fh, columns: Sequence[str], values: Sequence, n: int) -> None:
    """Header, then ``n`` rows from ``values`` (one sequence of ``n``
    values per column), byte-identical to ``csv.writer`` over
    ``_format_value`` of each cell.

    Each column is classified once (``_typed_column``); every
    ``_CSV_BLOCK_ROWS`` rows are then formatted by one call of the C++
    library (``native.format_csv``), or, without a C++ compiler, a
    column at a time in Python. Counters ``rows_written``,
    ``csv.native_rows`` (rows whose body the library assembled) and
    ``csv.python_columns`` (columns formatted one value at a time in
    Python: all of them without the library)."""
    typed, per_value = [], 0
    for v in values:
        col, slow = _typed_column(v)
        typed.append(col)
        per_value += slow
    header = [_quote(c) for c in columns]
    if len(columns) == 1:
        # csv.writer quotes the only field of a row when it is empty
        header = [c or '""' for c in header]
        if not isinstance(typed[0], np.ndarray):
            typed[0] = [c or '""' for c in typed[0]]
    fh.write(",".join(header) + "\n")
    use_native = native.available()
    for lo in range(0, n, _CSV_BLOCK_ROWS):
        block = [c[lo:lo + _CSV_BLOCK_ROWS] for c in typed]
        if use_native:
            fh.write(native.format_csv(block, min(n - lo, _CSV_BLOCK_ROWS)))
        else:
            rows = zip(*map(_format_column, block))
            fh.write("\n".join(map(",".join, rows)) + "\n")
    count("rows_written", n)
    count("csv.native_rows", n if use_native else 0)
    count("csv.python_columns", per_value if use_native else len(typed))


def _write_to(filename: Optional[str], columns: Sequence[str], values: Sequence, n: int) -> None:
    if filename is None:
        _write_csv(sys.stdout, columns, values, n)
        sys.stdout.flush()
    else:
        with open(filename, "w", newline="") as f:
            _write_csv(f, columns, values, n)


def write_search_csv_columns(
    cols: Dict[str, Sequence], filename: Optional[str] = None
) -> None:
    """``write_search_csv`` of a column-native result ({column: values})."""
    write_search_csv(SearchRows(cols), list(cols), filename)


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


def rows_to_csv(rows: Sequence[Dict], columns: Sequence[str]) -> str:
    """``write_search_csv``'s bytes as a string."""
    buf = io.StringIO()
    _write_csv(buf, columns, result_columns(rows, columns), len(rows))
    return buf.getvalue()


def write_search_csv(
    rows: Sequence[Dict],
    columns: Sequence[str],
    filename: Optional[str] = None,
) -> None:
    """A search result (``SearchRows`` or any sequence of row dicts) as
    CSV, the columns ``columns`` in that order, to ``filename`` or
    stdout. Span ``search.csv`` (counters of ``_write_csv``)."""
    with span("search.csv"):
        _write_to(filename, columns, result_columns(rows, columns), len(rows))
