"""K-mer stitching: join matched hashes back to k-mers and stitch maximal
matched segments — the "domain annotation" output (a copy of
``kmerseek_tpu/core/stitch.py``, which is pandas only).

Exact behavioral port of kmerseek's result post-processing
(kmerseek's src/python/kmerseek/search.py:37-121, 195-276), with
pandas standing in for polars:

* query k-mer table ⋈ target k-mer table on (encoded, hashval)
  (search.py:169, 204-213) — hp/dayhoff collisions fan out naturally;
* ⋈ search results on (match_name, query_name) (search.py:215-220);
* per match_name group (reference groups by match_name only —
  search.py:222-240 — a quirk kept for parity), rows sorted by
  start_query, k-mers are stitched: first k-mer whole, then each next
  k-mer contributes its last (Δstart) characters
  (single_stitch_together_kmers, search.py:37-58; note Δ==0 appends the
  *whole* k-mer — Python slicing quirk kept);
* the stitched "query" string advances by Δstart_match while "alpha"
  advances by Δstart_query (search.py:79-81) — kept verbatim;
* coordinates are 0-based half-open (search.py:92-96).

Output: the 10-column stitched CSV (match_name, query_name,
query_start, query_end, query, match_start, match_end, match, encoded,
length) sorted by (query_start, query_end), plus the exact stderr
report text pinned by kmerseek's tests/test_search.py:103-139.

``write_stitched`` is the one entry that ``search --extract-kmers`` and
a served block call: the streaming stitch, the report and the CSV.
Spans (``utils.metrics``): ``stitch.write`` around it, with children
``stitch.scan`` (one a sidecar; counters ``stitch.rows_scanned`` and
``stitch.rows_kept``), ``stitch.join``, ``stitch.segments`` (counter
``stitch.segments``) and ``stitch.csv``.
"""

from __future__ import annotations

import sys
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import pandas as pd

from ..utils.metrics import count, span

STITCH_COLUMNS = [
    "match_name",
    "query_name",
    "query_start",
    "query_end",
    "query",
    "match_start",
    "match_end",
    "match",
    "encoded",
    "length",
]


def single_stitch_together_kmers(kmers: Sequence[str], i_kmers: Sequence[int]) -> str:
    """search.py:37-58, mirroring ``kmer[-kmer_slice:]`` verbatim:
    Δ>0 appends the last Δ chars, Δ==0 the whole k-mer (the ``[-0:]``
    Python quirk), Δ<0 the chars from index |Δ| on (rows are sorted by
    start_query, so start_match deltas can go negative on multi-position
    or collision matches)."""
    stitched = ""
    prev = 0
    for i, (i_kmer, kmer) in enumerate(zip(i_kmers, kmers)):
        if i == 0:
            stitched = kmer
        else:
            delta = i_kmer - prev
            stitched += kmer[-delta:] if delta != 0 else kmer
        prev = i_kmer
    return stitched


def stitch_group(group: pd.DataFrame) -> Dict:
    """search.py:61-121 for one (match_name) group."""
    df = group.sort_values("start_query", kind="mergesort")
    match_name = df["match_name"].iloc[0]
    query_name = df["query_name"].iloc[0]

    query = single_stitch_together_kmers(
        list(df["kmer_query"]), list(df["start_match"])
    )
    alphabet = single_stitch_together_kmers(
        list(df["encoded"]), list(df["start_query"])
    )
    match = single_stitch_together_kmers(
        list(df["kmer_match"]), list(df["start_match"])
    )
    assert len(query) == len(alphabet) == len(match), (
        f"stitched length mismatch for {match_name}: "
        f"{len(query)}/{len(alphabet)}/{len(match)}"
    )
    length = len(query)
    match_start = int(df["start_match"].min())
    query_start = int(df["start_query"].min())
    match_end = match_start + length
    query_end = query_start + length
    to_print = (
        f"\n---\nQuery Name: {query_name}"
        f"\nMatch Name: {match_name}"
        f"\nquery: {query} ({query_start}-{query_end})\n"
        f"alpha: {alphabet}\n"
        f"match: {match} ({match_start}-{match_end})"
    )
    return {
        "match_name": match_name,
        "query_name": query_name,
        "query_start": query_start,
        "query_end": query_end,
        "query": query,
        "match_start": match_start,
        "match_end": match_end,
        "match": match,
        "encoded": alphabet,
        "length": length,
        "to_print": to_print,
    }


def _prep_kmers(kmers: pd.DataFrame, suffix: str) -> pd.DataFrame:
    """search.py:198-202: rename kmer/start/sequence_name/sequence_file."""
    renamer = {
        c: f"{c}{suffix}" for c in ("kmer", "start", "sequence_name", "sequence_file")
    }
    return kmers.rename(columns=renamer)


def join_query_target_kmers(
    query_kmers: pd.DataFrame, target_kmers: pd.DataFrame
) -> pd.DataFrame:
    """search.py:204-213: inner join on (encoded, hashval)."""
    q = _prep_kmers(query_kmers, "_query")
    t = _prep_kmers(target_kmers, "_match")
    return q.merge(t, on=["encoded", "hashval"], how="inner")


def _stitch_segments(merged: pd.DataFrame, group_by_pair: bool = False) -> list:
    """Per-group stitching without pandas groupby-apply overhead.

    Groups (match_name, first-occurrence order — pandas
    ``groupby(sort=False)`` semantics, search.py:222) are segmented
    with ``factorize`` + one stable lexsort that also applies the
    within-group ``start_query`` mergesort; the stitch loop then runs
    over plain Python lists. Same rows as ``stitch_group`` per group,
    ~30x less per-group overhead at proteome scale.

    ``group_by_pair`` groups by (match_name, query_name) instead of
    the reference's match_name-only quirk — with several queries, the
    quirk interleaves different queries' k-mers into one stitched row
    (search.py:222-240); the pair grouping keeps each query's match
    separate. Off by default for byte parity."""
    import numpy as np

    codes, _uniq = pd.factorize(merged["match_name"], sort=False)
    if group_by_pair:
        qcodes, quniq = pd.factorize(merged["query_name"], sort=False)
        pair_key = codes.astype(np.int64) * (len(quniq) + 1) + qcodes
        codes, _uniq = pd.factorize(pair_key, sort=False)
    start_query = merged["start_query"].to_numpy()
    # lexsort is stable: primary key codes (first-occurrence group
    # order), secondary start_query, original order breaking ties —
    # exactly groupby(sort=False) + sort_values(kind="mergesort")
    order = np.lexsort((start_query, codes))
    codes = codes[order]
    sq_l = start_query[order].tolist()
    sm_l = merged["start_match"].to_numpy()[order].tolist()
    mname_l = merged["match_name"].to_numpy()[order].tolist()
    qname_l = merged["query_name"].to_numpy()[order].tolist()
    kq_l = merged["kmer_query"].to_numpy()[order].tolist()
    enc_l = merged["encoded"].to_numpy()[order].tolist()
    km_l = merged["kmer_match"].to_numpy()[order].tolist()
    bounds = np.flatnonzero(
        np.concatenate([[True], codes[1:] != codes[:-1], [True]])
    )
    out = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        sq, sm = sq_l[lo:hi], sm_l[lo:hi]
        query = single_stitch_together_kmers(kq_l[lo:hi], sm)
        alphabet = single_stitch_together_kmers(enc_l[lo:hi], sq)
        match = single_stitch_together_kmers(km_l[lo:hi], sm)
        match_name = mname_l[lo]
        assert len(query) == len(alphabet) == len(match), (
            f"stitched length mismatch for {match_name}: "
            f"{len(query)}/{len(alphabet)}/{len(match)}"
        )
        length = len(query)
        match_start = int(min(sm))
        query_start = int(min(sq))
        match_end = match_start + length
        query_end = query_start + length
        query_name = qname_l[lo]
        out.append(
            {
                "match_name": match_name,
                "query_name": query_name,
                "query_start": query_start,
                "query_end": query_end,
                "query": query,
                "match_start": match_start,
                "match_end": match_end,
                "match": match,
                "encoded": alphabet,
                "length": length,
                "to_print": (
                    f"\n---\nQuery Name: {query_name}"
                    f"\nMatch Name: {match_name}"
                    f"\nquery: {query} ({query_start}-{query_end})\n"
                    f"alpha: {alphabet}\n"
                    f"match: {match} ({match_start}-{match_end})"
                ),
            }
        )
    return out


def stitch_results(
    search_rows: Sequence[Dict],
    query_kmers: pd.DataFrame,
    target_kmers: pd.DataFrame,
    group_by_pair: bool = False,
) -> Tuple[pd.DataFrame, str]:
    """Full post-processing: returns (stitched df, stderr report text).

    ``group_by_pair=True`` opts out of the reference's match_name-only
    grouping quirk (see ``_stitch_segments``)."""
    with span("stitch.join"):
        # the columns named, so that a block without rows joins to none
        results = pd.DataFrame(
            [(r["match_name"], r["query_name"]) for r in search_rows],
            columns=["match_name", "query_name"],
        )
        kmers = join_query_target_kmers(query_kmers, target_kmers)
        merged = results.merge(
            kmers,
            left_on=["match_name", "query_name"],
            right_on=["sequence_name_match", "sequence_name_query"],
            how="inner",
        )
    if merged.empty:
        return pd.DataFrame(columns=STITCH_COLUMNS), ""
    with span("stitch.segments"):
        stitched = pd.DataFrame(_stitch_segments(merged, group_by_pair)).sort_values(
            ["query_start", "query_end"], kind="mergesort"
        )
        count("stitch.segments", len(stitched))
        report = "\n".join(stitched["to_print"]) + "\n"
    return stitched[STITCH_COLUMNS].reset_index(drop=True), report


def _scan_kmer_parquet(
    path: str,
    names: set,
    hash_filter=None,
    batch_rows: int = 1 << 16,
) -> Tuple[pd.DataFrame, int]:
    """Stream a k-mer sidecar parquet and keep only rows that can
    survive the stitch joins: ``sequence_name ∈ names`` and (when
    given) ``hashval ∈ hash_filter`` (a SORTED uint64 array).

    This is the reference's LazyFrame predicate pushdown
    (search.py:179-181, entity.py:61-71) done by hand: peak memory is
    one parquet row group + the surviving rows, so a 10^8-row target
    sidecar streams through instead of materializing. The hash probe is
    a searchsorted membership test against the (small) query-side hash
    set — the same sorted-array join the posting machinery uses.

    Row order of the survivors is the file's row order, so downstream
    pandas merges see exactly the rows the eager path's merges would
    keep, in the same order — output stays byte-identical. Returns the
    kept rows and the number of rows read."""
    import numpy as np
    import pyarrow.parquet as pq

    with span("stitch.scan"):
        pf = pq.ParquetFile(path)
        kept, scanned = [], 0
        for batch in pf.iter_batches(batch_size=batch_rows):
            name_col = batch.column("sequence_name").to_numpy(zero_copy_only=False)
            mask = np.fromiter(
                (n in names for n in name_col), count=len(name_col), dtype=bool
            )
            if hash_filter is not None and mask.any():
                if len(hash_filter) == 0:
                    mask[:] = False
                else:
                    hv = batch.column("hashval").to_numpy(zero_copy_only=False)
                    pos = np.searchsorted(hash_filter, hv)
                    pos[pos == len(hash_filter)] = 0
                    mask &= hash_filter[pos] == hv
            n_kept = int(mask.sum())
            scanned += len(name_col)
            count("stitch.rows_scanned", len(name_col))
            count("stitch.rows_kept", n_kept)
            if n_kept:
                kept.append(batch.to_pandas().loc[mask])
    if not kept:
        cols = [
            "sequence_file",
            "sequence_name",
            "kmer",
            "hashval",
            "encoded",
            "start",
        ]
        return pd.DataFrame(columns=cols), scanned
    return pd.concat(kept, ignore_index=True), scanned


def stitch_results_streaming(
    search_rows: Sequence[Dict],
    query_kmers_pq: str,
    target_kmers_pq: str,
    group_by_pair: bool = False,
    batch_rows: int = 1 << 16,
) -> Tuple[pd.DataFrame, str]:
    """Memory-bounded :func:`stitch_results` over on-disk sidecars.

    The query sidecar streams first, filtered to the query names that
    actually matched; its distinct hashes (sorted, deduped) become the
    hash-join probe set for the target sidecar scan. Rows that the
    eager path's inner joins would drop never reach pandas, so memory
    is O(query-side rows + true join rows), independent of the target
    sidecar size. Output is byte-identical to the eager path (pinned
    by tests/test_torch_stitch.py)."""
    stitched, report, _counts = _stitch_streaming(
        search_rows, query_kmers_pq, target_kmers_pq, group_by_pair, batch_rows
    )
    return stitched, report


class StitchCounts(NamedTuple):
    rows_scanned: int  # sidecar rows read, both sidecars
    rows_kept: int  # of them, rows that can survive the joins
    segments: int  # stitched rows


def _stitch_streaming(search_rows, query_kmers_pq, target_kmers_pq, group_by_pair, batch_rows):
    """:func:`stitch_results_streaming` with its ``StitchCounts``."""
    import numpy as np

    query_names = {r["query_name"] for r in search_rows}
    match_names = {r["match_name"] for r in search_rows}
    q, q_scanned = _scan_kmer_parquet(query_kmers_pq, query_names, batch_rows=batch_rows)
    q_hashes = np.unique(q["hashval"].to_numpy(dtype=np.uint64, copy=False))
    t, t_scanned = _scan_kmer_parquet(
        target_kmers_pq, match_names, hash_filter=q_hashes, batch_rows=batch_rows
    )
    stitched, report = stitch_results(search_rows, q, t, group_by_pair=group_by_pair)
    return stitched, report, StitchCounts(q_scanned + t_scanned, len(q) + len(t), len(stitched))


def _write_text(text: str, path: Optional[str], stream) -> None:
    """``text`` to the file ``path``, or to ``stream`` (then flushed)."""
    if path is None:
        stream.write(text)
        stream.flush()
    else:
        with open(path, "w") as f:
            f.write(text)


def write_stitched(
    search_rows: Sequence[Dict],
    query_kmers_pq: str,
    target_kmers_pq: str,
    out: Optional[str] = None,
    report_out: Optional[str] = None,
    group_by_pair: bool = False,
) -> Tuple[pd.DataFrame, StitchCounts]:
    """The stitched tail of ``search --extract-kmers``: stitch the
    manysearch rows over the two on-disk sidecars
    (:func:`stitch_results_streaming`), write the report and a newline
    to ``report_out`` (default: standard error), then the stitched CSV to
    ``out`` (default: standard output). Returns the stitched frame and
    its ``StitchCounts``."""
    with span("stitch.write"):
        stitched, report, counts = _stitch_streaming(
            search_rows, query_kmers_pq, target_kmers_pq, group_by_pair, 1 << 16
        )
        _write_text(report + "\n", report_out, sys.stderr)
        with span("stitch.csv"):
            _write_text(stitched_to_csv(stitched), out, sys.stdout)
    return stitched, counts


def stitched_to_csv(stitched: pd.DataFrame) -> str:
    """10-column CSV, reference column order (search.py:249-263)."""
    import csv as _csv
    import io

    buf = io.StringIO()
    w = _csv.writer(buf, lineterminator="\n")
    w.writerow(STITCH_COLUMNS)
    w.writerows(stitched[STITCH_COLUMNS].itertuples(index=False, name=None))
    return buf.getvalue()
