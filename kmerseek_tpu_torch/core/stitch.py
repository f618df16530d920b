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
a served block call: the streaming stitch, the report and the CSV. The
search result comes in as ``search.SearchRows`` (or any sequence of row
dicts), read through ``search.result_columns``; the CSV goes through the
search CSV writer (``search._write_csv``).
Spans (``utils.metrics``): ``stitch.write`` around it, with children
``stitch.scan`` (one a sidecar; counters ``stitch.rows_scanned``,
``stitch.hash_hits``, ``stitch.rows_kept`` and ``stitch.groups_decoded``),
``stitch.join``, ``stitch.segments`` (counter ``stitch.segments``) and
``stitch.csv``.
"""

from __future__ import annotations

import io
import sys
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import pandas as pd

from ..utils.metrics import count, span
from .search import _write_csv, result_columns

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
        names = ["match_name", "query_name"]
        # text columns, as pandas infers them, also for a block without rows
        results = pd.DataFrame(dict(zip(names, result_columns(search_rows, names))), dtype=str)
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


# 2^20 one-byte flags (1 MiB): a row that is not a hit is a candidate with
# odds len(hash_filter) / 2^20, under 0.5% up to 4,400 query hashes
_PROBE_BITS = 20


def _hash_hits(hashes, hash_filter, bitmap):
    """Indices of ``hashes`` (uint64) that are in ``hash_filter`` (a
    SORTED uint64 array), in order. ``bitmap`` flags the filter's top
    ``_PROBE_BITS`` bits, so only the few candidates it lets through
    are looked up exactly; all in uint64 order."""
    import numpy as np

    cand = np.flatnonzero(bitmap[hashes >> np.uint64(64 - _PROBE_BITS)])
    got = hashes[cand]
    pos = np.searchsorted(hash_filter, got)
    pos[pos == len(hash_filter)] = 0
    return cand[hash_filter[pos] == got]


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
    (search.py:179-181, entity.py:61-71) done by hand, one parquet row
    group at a time, so a 10^8-row target sidecar streams through instead
    of materializing. In each row group the ``hashval`` column alone is
    probed first; ``sequence_name`` is read (as a dictionary, its
    distinct names tested once) only for the hash hits, and the other
    columns only in a group where some row passed both. No Python object
    is built for a row that cannot join. Without ``hash_filter`` (the
    query side) every row goes to the name test. ``batch_rows`` is kept
    for callers; the read unit is the file's row group.

    The decode of a group's other columns, most of the scan's time, runs
    in a second thread while this one probes the next group: at most one
    group's string columns are decoded at a time, beside the next group's
    hashes and names.

    Row order of the survivors is the file's row order, and their
    columns have the types a plain read of the file gives, so downstream
    pandas merges see exactly the rows the eager path's merges would
    keep, in the same order — output stays byte-identical. Returns the
    kept rows and the number of rows read.

    Counters on the ``stitch.scan`` span: ``stitch.rows_scanned`` (rows
    whose hash, or name without a hash filter, was tested),
    ``stitch.hash_hits`` (of them, rows that pass the hash probe; all
    without a filter), ``stitch.rows_kept`` and ``stitch.groups_decoded``
    (row groups whose other columns were read)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    with span("stitch.scan"):
        schema = pq.read_schema(path)
        pf = pq.ParquetFile(path, read_dictionary=["sequence_name"])
        decoder_pf = pq.ParquetFile(path)  # a ParquetFile is not shared between threads
        wanted = pa.array(list(names), pa.large_string())
        if hash_filter is not None:
            hash_filter = np.asarray(hash_filter, dtype=np.uint64)
            bitmap = np.zeros(1 << _PROBE_BITS, dtype=bool)
            bitmap[hash_filter >> np.uint64(64 - _PROBE_BITS)] = True

        def survivors(g, rows, read):
            rest = [c for c in schema.names if c not in read]
            read.update(zip(rest, decoder_pf.read_row_group(g, columns=rest).columns))
            table = pa.table([read[c].take(rows) for c in schema.names], names=schema.names)
            return table.cast(schema)

        kept, scanned, decoding = [], 0, None
        with ThreadPoolExecutor(1) as decoder:
            for g in range(pf.num_row_groups):
                n = pf.metadata.row_group(g).num_rows
                read = {}  # column name -> the row group's whole column
                rows = np.arange(n)
                if hash_filter is not None:
                    read["hashval"] = pf.read_row_group(g, columns=["hashval"]).column(0)
                    rows = _hash_hits(read["hashval"].to_numpy(), hash_filter, bitmap)
                scanned += n
                count("stitch.rows_scanned", n)
                count("stitch.hash_hits", len(rows))
                if len(rows):
                    read["sequence_name"] = pf.read_row_group(g, columns=["sequence_name"]).column(0)
                    # a dictionary column: is_in looks each distinct name up once
                    hit = pc.is_in(read["sequence_name"].take(rows), value_set=wanted)
                    rows = rows[hit.to_numpy()]
                count("stitch.rows_kept", len(rows))
                count("stitch.groups_decoded", int(len(rows) > 0))
                if len(rows):
                    if decoding is not None:
                        kept.append(decoding.result())
                    decoding = decoder.submit(survivors, g, rows, read)
            if decoding is not None:
                kept.append(decoding.result())
        if kept:
            # numbered 0..n-1 even where a pandas-written sidecar stores an index
            return pa.concat_tables(kept).to_pandas().reset_index(drop=True), scanned
    cols = [
        "sequence_file",
        "sequence_name",
        "kmer",
        "hashval",
        "encoded",
        "start",
    ]
    return pd.DataFrame(columns=cols), scanned


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

    match_names, query_names = result_columns(search_rows, ["match_name", "query_name"])
    q, q_scanned = _scan_kmer_parquet(query_kmers_pq, set(query_names), batch_rows=batch_rows)
    q_hashes = np.unique(q["hashval"].to_numpy(dtype=np.uint64, copy=False))
    t, t_scanned = _scan_kmer_parquet(
        target_kmers_pq, set(match_names), hash_filter=q_hashes, batch_rows=batch_rows
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
    """10-column CSV, reference column order (search.py:249-263), through
    the search CSV writer."""
    buf = io.StringIO()
    _write_csv(buf, STITCH_COLUMNS, [stitched[c].to_numpy() for c in STITCH_COLUMNS], len(stitched))
    return buf.getvalue()
