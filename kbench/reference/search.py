"""Plain numpy manysearch: the 22 columns of kmerseek's search CSV for
every query x target pair that shares a kept hash.

Definitions (sourmash / branchwater ``manysearch``, threshold 0): with
n shared hashes, q and t the two sketch sizes, the target's abundances
of the shared hashes a_1..a_n and W the target's total abundance,

  containment = n/q, jaccard = n/(q + t - n), max_containment =
  max(n/q, n/t), average/median/std_abund = mean, median, population
  standard deviation of a_i, n_weighted_found = sum a_i,
  total_weighted_hashes = W, containment_target_in_query = n/t,
  f_weighted_target_in_query = sum a_i / W, ksize = 3k,
  *_containment_ani = containment^(1/3k) (0 for 0), average and max of
  the query's and the match's.

Rows are ordered by (query name, match name). ``dtype`` is the float
type of the statistics: float64 as the CSV carries them, float32 for
the precision control.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .sketch import Postings, Sketches, sourmash_md5

COLUMNS = [
    "query_name", "query_md5", "match_name", "containment", "intersect_hashes",
    "ksize", "scaled", "moltype", "match_md5", "jaccard", "max_containment",
    "average_abund", "median_abund", "std_abund", "query_containment_ani",
    "match_containment_ani", "average_containment_ani", "max_containment_ani",
    "n_weighted_found", "total_weighted_hashes", "containment_target_in_query",
    "f_weighted_target_in_query",
]
FLOAT_COLUMNS = {
    "containment", "jaccard", "max_containment", "average_abund", "median_abund",
    "std_abund", "query_containment_ani", "match_containment_ani",
    "average_containment_ani", "max_containment_ani", "containment_target_in_query",
    "f_weighted_target_in_query",
}


class TargetStats:
    """What a search needs of the target, worked out once."""

    def __init__(self, t: Sketches, post: Postings, k: int):
        self.t, self.post, self.k = t, post, k
        self.sizes = np.diff(t.offsets)
        self.weight = np.array([int(t.abundances[a:b].sum()) for a, b in
                                zip(t.offsets[:-1], t.offsets[1:])], np.int64)
        self._md5: Dict[int, str] = {}

    def md5(self, i: int) -> str:
        if i not in self._md5:
            t = self.t
            self._md5[i] = sourmash_md5(t.mins[t.offsets[i]:t.offsets[i + 1]], self.k)
        return self._md5[i]


def manysearch(q: Sketches, ts: TargetStats, scaled: int, moltype: str, dtype=np.float64) -> List[dict]:
    k, post = ts.k, ts.post
    qsizes = np.diff(q.offsets)
    qrow = np.repeat(np.arange(len(q.names)), qsizes)
    lo = np.searchsorted(post.hashes, q.mins, "left")
    hi = np.searchsorted(post.hashes, q.mins, "right")
    cnt = hi - lo
    pos = np.repeat(lo - np.concatenate([[0], np.cumsum(cnt)])[:-1], cnt) + np.arange(cnt.sum())
    pq = np.repeat(qrow, cnt)
    pt = post.tid[pos]
    pa = post.ab[pos]
    order = np.lexsort((pa, pt, pq))
    pq, pt, pa = pq[order], pt[order], pa[order]
    rows = []
    if len(pq) == 0:
        return rows
    cut = np.flatnonzero((pq[1:] != pq[:-1]) | (pt[1:] != pt[:-1])) + 1
    bounds = np.concatenate([[0], cut, [len(pq)]])
    f = dtype
    k3 = 3 * k
    qmd5 = {}

    def ani(c):
        return f(c) ** (f(1.0) / f(k3)) if c > 0 else f(0.0)

    for a, b in zip(bounds[:-1], bounds[1:]):
        qi, ti = int(pq[a]), int(pt[a])
        ab = pa[a:b]
        n = b - a
        qs, tsz, w = int(qsizes[qi]), int(ts.sizes[ti]), int(ts.weight[ti])
        s = int(ab.sum())
        mean = f(s) / f(n)
        dev = ab.astype(f) - mean
        std = np.sqrt(np.sum(dev * dev, dtype=f) / f(n))
        median = (f(ab[(n - 1) // 2]) + f(ab[n // 2])) / f(2.0)
        cq = f(n) / f(qs)
        ct = f(n) / f(tsz)
        aq, at = ani(cq), ani(ct)
        if qi not in qmd5:
            qmd5[qi] = sourmash_md5(q.mins[q.offsets[qi]:q.offsets[qi + 1]], k)
        rows.append({
            "query_name": q.names[qi], "query_md5": qmd5[qi],
            "match_name": ts.t.names[ti], "containment": cq, "intersect_hashes": n,
            "ksize": k3, "scaled": scaled, "moltype": moltype, "match_md5": ts.md5(ti),
            "jaccard": f(n) / f(qs + tsz - n), "max_containment": max(cq, ct),
            "average_abund": mean, "median_abund": median, "std_abund": std,
            "query_containment_ani": aq, "match_containment_ani": at,
            "average_containment_ani": (aq + at) / f(2.0), "max_containment_ani": max(aq, at),
            "n_weighted_found": s, "total_weighted_hashes": w,
            "containment_target_in_query": ct, "f_weighted_target_in_query": f(s) / f(w),
        })
    rows.sort(key=lambda r: (r["query_name"], r["match_name"]))
    return rows
