"""Plain numpy and Python k-mer sidecar and stitched domain annotation,
written from kmerseek's published definitions (``SURVEY.md`` row 26;
kmerseek ``src/python/kmerseek/sig2kmer.py:113-183`` for the sidecar,
``search.py:37-121`` and ``195-276`` for the joins and the stitch) and
nothing of the program under test. The hashes come from
``kbench.reference.sketch``.

* Sidecar: one row per kept window (hash <= max_hash) of every cleaned
  sequence, in row-major (sequence, start) order, with the columns
  ``sequence_file, sequence_name, kmer, hashval, encoded, start``:
  ``kmer`` the window's residues, ``encoded`` its bytes in the
  moltype's alphabet, ``start`` its 0-based offset.
* Joins: the query sidecar with the target sidecar on ``(encoded,
  hashval)``; then with the search results on (match, query). At
  threshold 0 the search results are every (query, target) pair that
  shares a kept hash, so the second join keeps every joined k-mer pair
  and only fixes the rows' order: the results' (query name, match name)
  order, then the query sidecar's, then the target sidecar's.
* Stitch, per group: rows sorted by ``start_query``, stably; each string
  starts with the first k-mer whole and appends ``kmer[-d:]`` of each
  next k-mer, d the step of its start (so d == 0 appends the whole
  k-mer and d < 0 the k-mer from |d| on). ``query`` joins the query's
  k-mers over the steps of ``start_match``, ``encoded`` the encoded
  k-mers over the steps of ``start_query``, ``match`` the target's
  k-mers over the steps of ``start_match``. The three lengths must be
  equal (kmerseek's assertion). Coordinates are 0-based half-open:
  ``query_start`` = least ``start_query``, ``query_end`` = it plus the
  length; likewise for the match. The group's ``query_name`` is that of
  its first row.
* Rows ordered by ``(query_start, query_end)``; the report is one entry
  a row, ``"\\n---\\nQuery Name: ..."`` as kmerseek prints it, joined by
  newlines with one more after the last, and the newline that printing
  adds.

Departures from the published code: ``group_by_pair=True`` groups the
stitch by (match, query) pair, where kmerseek groups by match name alone
(``search.py:222``), which merges the k-mers of several queries that hit
one target into one row; the served block search states the pair
grouping. The reference also hashes every window of the target once
for a check: finding, independently of the program, which targets share
a hash with a block needs every target's kept hashes. Strings are made
only for the rows that join.
"""

from __future__ import annotations

import collections
import csv
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from .sketch import ENCODINGS, clean, max_hash, read_fasta, window_hashes

SIDECAR_COLUMNS = ["sequence_file", "sequence_name", "kmer", "hashval", "encoded", "start"]
STITCH_COLUMNS = ["match_name", "query_name", "query_start", "query_end", "query", "match_start",
                  "match_end", "match", "encoded", "length"]


class Windows(NamedTuple):
    """The kept windows of one FASTA file, in row-major order."""

    names: List[str]
    seqs: List[bytes]  # cleaned
    encoded: List[bytes]  # the cleaned sequences in the moltype's alphabet
    sid: np.ndarray  # (n,) int64 sequence of each kept window
    start: np.ndarray  # (n,) int64
    hashval: np.ndarray  # (n,) uint64


def kept_windows(fasta: str, k: int, scaled: int, moltype: str, hash_dtype=np.uint64) -> Windows:
    """``hash_dtype=np.float64`` carries the hashes through f64, for the
    precision control: the filter compares and the sidecar holds the
    rounded values."""
    names, raw = read_fasta(fasta)
    seqs = [clean(s) for s in raw]
    h, sid = window_hashes(seqs, k, moltype)
    nwin = np.maximum(np.array([len(s) for s in seqs], np.int64) - k + 1, 0)
    first = np.concatenate([[0], np.cumsum(nwin)])[:-1]
    start = np.arange(len(h), dtype=np.int64) - np.repeat(first, nwin)
    if hash_dtype is np.uint64:
        keep = h <= np.uint64(max_hash(scaled))
    else:
        hf = h.astype(hash_dtype)
        keep = hf <= hash_dtype(max_hash(scaled))
        with np.errstate(all="ignore"):
            h = hf.astype(np.uint64)
    table = ENCODINGS[moltype].tobytes()
    return Windows(names, seqs, [s.translate(table) for s in seqs], sid[keep], start[keep], h[keep])


def _kmer(w: Windows, i: int, k: int) -> str:
    s, a = int(w.sid[i]), int(w.start[i])
    return w.seqs[s][a:a + k].decode()


def _encoded(w: Windows, i: int, k: int) -> str:
    s, a = int(w.sid[i]), int(w.start[i])
    return w.encoded[s][a:a + k].decode()


def sidecar_columns(w: Windows, k: int, sequence_file: str) -> Dict[str, list]:
    """The sidecar of every kept window, column by column."""
    n = len(w.sid)
    return {
        "sequence_file": [sequence_file] * n,
        "sequence_name": [w.names[s] for s in w.sid.tolist()],
        "kmer": [_kmer(w, i, k) for i in range(n)],
        "hashval": w.hashval.tolist(),
        "encoded": [_encoded(w, i, k) for i in range(n)],
        "start": w.start.tolist(),
    }


def _stitch_string(kmers: List[str], starts: List[int]) -> str:
    out = kmers[0]
    for prev, cur, kmer in zip(starts, starts[1:], kmers[1:]):
        out += kmer[-(cur - prev):]
    return out


def stitch(q: Windows, t: Windows, k: int, group_by_pair: bool) -> Tuple[List[dict], str]:
    """The stitched rows, in order, and the report as printed. Raises
    AssertionError where kmerseek's stitched lengths differ."""
    by_hash = np.argsort(t.hashval, kind="stable")
    lo = np.searchsorted(t.hashval[by_hash], q.hashval, "left")
    hi = np.searchsorted(t.hashval[by_hash], q.hashval, "right")
    joined = []  # (query name, match name, query row, target row)
    for qi in np.flatnonzero(hi > lo).tolist():
        enc = _encoded(q, qi, k)
        for ti in sorted(by_hash[lo[qi]:hi[qi]].tolist()):
            if _encoded(t, ti, k) == enc:
                joined.append((q.names[q.sid[qi]], t.names[t.sid[ti]], qi, ti))
    joined.sort(key=lambda r: r[:2])  # stable: the results' order
    groups: Dict[tuple, list] = {}
    for qname, mname, qi, ti in joined:
        groups.setdefault((mname, qname) if group_by_pair else (mname,), []).append(
            (int(q.start[qi]), int(t.start[ti]), qname, _kmer(q, qi, k), _encoded(q, qi, k),
             _kmer(t, ti, k)))
    rows = []
    for key, members in groups.items():
        members.sort(key=lambda m: m[0])
        sq = [m[0] for m in members]
        sm = [m[1] for m in members]
        query = _stitch_string([m[3] for m in members], sm)
        alpha = _stitch_string([m[4] for m in members], sq)
        match = _stitch_string([m[5] for m in members], sm)
        if not len(query) == len(alpha) == len(match):
            raise AssertionError(f"stitched length mismatch for {key[0]}: {len(query)}/{len(alpha)}/{len(match)}")
        n = len(query)
        rows.append({"match_name": key[0], "query_name": members[0][2], "query_start": min(sq),
                     "query_end": min(sq) + n, "query": query, "match_start": min(sm),
                     "match_end": min(sm) + n, "match": match, "encoded": alpha, "length": n})
    rows.sort(key=lambda r: (r["query_start"], r["query_end"]))
    entries = [report_entry(r) for r in rows]
    report = "\n".join(entries) + "\n" if entries else ""
    return rows, report + "\n"


def report_entry(r: dict) -> str:
    return (f"\n---\nQuery Name: {r['query_name']}\nMatch Name: {r['match_name']}\n"
            f"query: {r['query']} ({r['query_start']}-{r['query_end']})\nalpha: {r['encoded']}\n"
            f"match: {r['match']} ({r['match_start']}-{r['match_end']})")


def _multiset_off(got: list, want: list) -> Tuple[int, collections.Counter]:
    g, w = collections.Counter(got), collections.Counter(want)
    return sum((g - w).values()) + sum((w - g).values()), g & w


def compare_sidecar(path: str, want: Dict[str, list]) -> Dict[str, int]:
    """``kmers_rows_off``: rows missing or extra (by sequence and start),
    and rows out of row-major order; ``kmers_cells_off``: cells of the
    rows in both that differ. A file without the six columns counts
    every wanted row as missing."""
    import pyarrow.parquet as pq

    table = pq.read_table(path)
    if table.column_names != SIDECAR_COLUMNS:
        return {"kmers_rows_off": len(want["start"]) + 1, "kmers_cells_off": 0}
    got = {c: table.column(c).to_pylist() for c in SIDECAR_COLUMNS}
    gkeys = list(zip(got["sequence_name"], got["start"]))
    wkeys = list(zip(want["sequence_name"], want["start"]))
    rows_off, _ = _multiset_off(gkeys, wkeys)
    rank = {name: i for i, name in enumerate(dict.fromkeys(want["sequence_name"]))}
    order = [(rank.get(n, -1), s) for n, s in gkeys]
    rows_off += sum(a > b for a, b in zip(order, order[1:]))
    at = {key: i for i, key in reversed(list(enumerate(gkeys)))}
    cells = 0
    for j, key in enumerate(wkeys):
        i = at.get(key)
        if i is not None:
            cells += sum(got[c][i] != want[c][j] for c in ("sequence_file", "kmer", "hashval", "encoded"))
    return {"kmers_rows_off": rows_off, "kmers_cells_off": cells}


def compare_stitched(path: str, want: List[dict]) -> Dict[str, int]:
    """``stitched_rows_off``: a header that differs, rows missing or extra
    (as multisets of (match, query)), and rows out of (query_start,
    query_end) order; ``stitched_cells_off``: cells of the rows in both
    that differ."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader, [])
        got = list(reader)
    if header != STITCH_COLUMNS:
        return {"stitched_rows_off": len(want) + 1, "stitched_cells_off": 0}
    bad = [g for g in got if len(g) != len(STITCH_COLUMNS)]
    got = [dict(zip(STITCH_COLUMNS, g)) for g in got if len(g) == len(STITCH_COLUMNS)]
    rows_off, _ = _multiset_off([(g["match_name"], g["query_name"]) for g in got],
                                [(w["match_name"], w["query_name"]) for w in want])
    rows_off += len(bad)
    spans = []
    for g in got:
        try:
            spans.append((int(g["query_start"]), int(g["query_end"])))
        except ValueError:
            rows_off += 1
    rows_off += sum(a > b for a, b in zip(spans, spans[1:]))
    by_key = {(g["match_name"], g["query_name"]): g for g in got}
    cells = 0
    for w in want:
        g = by_key.get((w["match_name"], w["query_name"]))
        if g is not None:
            cells += sum(g[c] != str(w[c]) for c in STITCH_COLUMNS[2:])
    return {"stitched_rows_off": rows_off, "stitched_cells_off": cells}


def report_entries(text: str):
    """The entries of a printed report, or None where it is not one."""
    if text == "\n":
        return []
    if not text.endswith("\n\n") or not text.startswith("\n---\n"):
        return None
    return ["\n---\n" + e for e in text[len("\n---\n"):-2].split("\n---\n")]


def compare_report(path: str, want: str) -> Dict[str, int]:
    """``report_off``: entries missing, extra or different (a different
    entry is one missing and one extra), and 1 more where the text is
    not a report."""
    with open(path) as f:
        got = report_entries(f.read())
    entries = report_entries(want)
    if got is None:
        return {"report_off": len(entries) + 1}
    off, _ = _multiset_off(got, entries)
    return {"report_off": off}
