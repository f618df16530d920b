"""Readers of what the program wrote, and the comparisons with the plain
reference that decide ``correct``. Each comparison returns counts of
what differs (exact: limit 0) or the largest relative error of a float.

* ``.sig.zip``: a zip whose ``signatures/*.sig.gz`` members are gzipped
  JSON lists of sourmash signatures, with ``SOURMASH-MANIFEST.csv``.
* ``.ksx``: a directory of ``.npy`` members (CSR sketches and postings),
  ``metadata.json`` and ``manifest.json``.
* the search CSV: a header of the 22 columns, then one row per pair.
"""

from __future__ import annotations

import csv
import gzip
import io
import json
import math
import os
import zipfile
from typing import Dict, List

import numpy as np

from .search import COLUMNS, FLOAT_COLUMNS
from .sketch import Sketches, bucket_table, max_hash, postings, sourmash_md5

KSX_MEMBERS = ("mins", "abundances", "offsets", "inv_g_hi", "inv_g_lo", "inv_tid", "inv_ab",
               "inv_bucket_starts")


def read_ksx(path: str) -> dict:
    out = {m: np.load(os.path.join(path, f"{m}.npy")) for m in KSX_MEMBERS}
    with open(os.path.join(path, "metadata.json")) as f:
        out["metadata"] = json.load(f)
    with open(os.path.join(path, "manifest.json")) as f:
        out["manifest"] = json.load(f)
    return out


def _differ(a: np.ndarray, b: np.ndarray) -> int:
    """Positions that differ, counting a length difference in full."""
    n = min(len(a), len(b))
    return int(np.count_nonzero(a[:n] != b[:n])) + abs(len(a) - len(b))


def compare_ksx(path: str, ref: Sketches, k: int, scaled: int, moltype: str, fasta: str) -> Dict[str, int]:
    """``sigs_off``: signatures whose name, mins or abundances differ;
    ``postings_off``: posting fields, bucket entries and shape numbers
    that differ; ``meta_off``: metadata fields and md5s that differ."""
    got = read_ksx(path)
    meta = got["metadata"]
    T = len(ref.names)
    names = meta.get("names", [])
    offs = got["offsets"].astype(np.int64)
    sigs_off = abs(len(names) - T) + (0 if len(offs) == T + 1 else T)
    if len(offs) == T + 1:
        for i in range(min(T, len(names))):
            a, b = ref.offsets[i], ref.offsets[i + 1]
            c, d = offs[i], offs[i + 1]
            same = (names[i] == ref.names[i]
                    and np.array_equal(got["mins"][c:d], ref.mins[a:b])
                    and np.array_equal(got["abundances"][c:d], ref.abundances[a:b]))
            sigs_off += not same
    post = postings(ref)
    starts, shift = bucket_table(post.hashes)
    g = (got["inv_g_hi"].astype(np.uint64) << np.uint64(32)) | got["inv_g_lo"].astype(np.uint64)
    postings_off = (_differ(g, post.hashes) + _differ(got["inv_tid"].astype(np.int64), post.tid)
                    + _differ(got["inv_ab"].astype(np.int64), post.ab)
                    + _differ(got["inv_bucket_starts"].astype(np.int64), starts))
    runs = np.diff(np.flatnonzero(np.concatenate([[True], post.hashes[1:] != post.hashes[:-1], [True]])))
    shape = [T, int(runs.max(initial=1)), int(np.diff(starts).max(initial=1)), shift]
    postings_off += sum(int(a != b) for a, b in zip(got["manifest"].get("inverted_shape", []), shape))
    md5s = meta.get("md5s", [])
    want = {"ksize": k, "scaled": scaled, "moltype": moltype, "n_signatures": T,
            "source_fasta": fasta, "has_sequences": False}
    meta_off = sum(meta.get(key) != v for key, v in want.items())
    meta_off += abs(len(md5s) - T) + sum(
        md5s[i] != sourmash_md5(ref.mins[ref.offsets[i]:ref.offsets[i + 1]], k)
        for i in range(min(T, len(md5s))))
    return {"sigs_off": sigs_off, "postings_off": postings_off, "meta_off": meta_off}


def read_sig_zip(path: str):
    sigs, manifest = [], []
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            if name.startswith("signatures/"):
                sigs.extend(json.loads(gzip.decompress(z.read(name))))
        text = z.read("SOURMASH-MANIFEST.csv").decode()
    lines = text.splitlines()
    if lines and lines[0].startswith("#"):
        manifest = list(csv.DictReader(io.StringIO("\n".join(lines[1:]))))
    return sigs, manifest


def compare_sig_zip(path: str, ref: Sketches, k: int, scaled: int, moltype: str, fasta: str) -> Dict[str, int]:
    """``sigzip_off``: reference signatures missing, differing in any field,
    or without their manifest row, plus signatures and rows that are
    extra."""
    sigs, manifest = read_sig_zip(path)
    by_name = {}
    for s in sigs:
        by_name.setdefault(s.get("name"), []).append(s)
    rows = {}
    for r in manifest:
        rows.setdefault(r.get("name"), []).append(r)
    off = abs(len(sigs) - len(ref.names)) + abs(len(manifest) - len(ref.names))
    mh = max_hash(scaled)
    for i, name in enumerate(ref.names):
        mins = ref.mins[ref.offsets[i]:ref.offsets[i + 1]]
        ab = ref.abundances[ref.offsets[i]:ref.offsets[i + 1]]
        md5 = sourmash_md5(mins, k)
        got = by_name.get(name, [])
        ok = len(got) == 1
        if ok:
            s = got[0]
            inner = s.get("signatures") or [{}]
            m = inner[0]
            ok = (len(inner) == 1 and s.get("filename") == fasta and s.get("hash_function") == "0.murmur64"
                  and m.get("ksize") == 3 * k and m.get("seed") == 42 and m.get("max_hash") == mh
                  and m.get("molecule") == moltype and m.get("md5sum") == md5
                  and m.get("mins") == [int(x) for x in mins]
                  and m.get("abundances") == [int(x) for x in ab])
        row = rows.get(name, [])
        ok = ok and len(row) == 1 and (
            row[0].get("md5") == md5 and row[0].get("ksize") == str(k)
            and row[0].get("moltype") == moltype and row[0].get("scaled") == str(scaled)
            and row[0].get("n_hashes") == str(len(mins)) and row[0].get("filename") == fasta)
        off += not ok
    return {"sigzip_off": off}


def compare_csv(path: str, want: List[dict]) -> Dict[str, float]:
    """``rows_off``: a header that differs, and rows missing, extra or out
    of (query, match) order; ``exact_cells_off``: text and integer cells
    that differ; ``float_rel_err``: the largest relative error of a float
    cell (inf for one that is not a number)."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader, [])
        got = list(reader)
    rows_off = int(header != COLUMNS)
    rows_off += abs(len(got) - len(want))
    exact, worst = 0, 0.0
    col = {c: header.index(c) for c in COLUMNS if c in header}
    for g, w in zip(got, want):
        if len(g) != len(header) or len(col) != len(COLUMNS):
            rows_off += 1
            continue
        if g[col["query_name"]] != w["query_name"] or g[col["match_name"]] != w["match_name"]:
            rows_off += 1
            continue
        for c in COLUMNS:
            text, ref = g[col[c]], w[c]
            if c in FLOAT_COLUMNS:
                try:
                    v = float(text)
                except ValueError:
                    v = math.nan
                ref = float(ref)
                err = abs(v - ref) / max(abs(ref), 1e-300) if ref != 0 else abs(v)
                worst = max(worst, err if err == err else math.inf)
            else:
                exact += text != str(ref)
    return {"rows_off": rows_off, "exact_cells_off": exact, "float_rel_err": worst}
