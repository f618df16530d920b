"""The port's k-mer sidecar and stitched search (``write_stitched``)
against the benchmark's plain reference (``kbench/reference/stitch.py``,
numpy and Python, nothing of either package): the block's sidecar row
for row, the stitched CSV and the report with per-pair and with
kmerseek's match-name grouping, ``write_stitched`` against the CLI's
former inline tail, the spans and counters of both layers, planted
faults that the comparison must read as not correct, the sidecar scan
against its former row-at-a-time version on synthetic sidecars, with and
without their hash index, and the scan's fall-back where an index is
missing, stale or damaged."""

import os

import click
import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from kbench.reference import stitch as ref
from kmerseek_tpu_torch.core import kmers, stitch
from kmerseek_tpu_torch.core.index import IndexConfig, ProteomeIndex
from kmerseek_tpu_torch.core.search import MANYSEARCH_COLUMNS, SearchRows, manysearch
from kmerseek_tpu_torch.utils import metrics
from test_torch_index import write_fasta

AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
SETTINGS = [("dayhoff", 24, 5), ("dayhoff", 12, 2), ("protein", 10, 1)]
CHECKS = ("kmers_rows_off", "kmers_cells_off", "stitched_rows_off", "stitched_cells_off", "report_off")


def _corpus(d, seed, shared_target):
    """``t.fa``: 30 seeded proteins (a duplicated one, a lowercase /
    ambiguous / stop-codon one, comma names); ``q.fa``: 90-aa segments of
    targets 0, 2, 6, 9 with three substitutions each, a lowercase one
    with B/Z from target 12, one unrelated query, and with
    ``shared_target`` a second segment of target 9. Returns (query path,
    target path)."""
    t = str(d / "t.fa")
    targets = write_fasta(t, n=30, seed=seed, max_len=400)
    rng = np.random.default_rng(seed + 1)
    plants = [(0, 3), (2, 20), (6, 40), (9, 0)] + ([(9, 150)] if shared_target else [])
    queries = []
    for i, a in plants:
        src = targets[i].upper()
        a = min(a, max(len(src) - 90, 0))
        seg = bytearray(src[a:a + 90])
        for j in rng.choice(len(seg), size=min(3, len(seg)), replace=False):
            seg[j] = AA[(AA.tolist().index(seg[j]) + 1) % 20] if seg[j] in AA else ord("A")
        queries.append(bytes(seg))
    queries.append(b"mkbz" + targets[12].upper()[100:180])
    queries.append(AA[rng.integers(0, 20, size=120)].tobytes())
    q = str(d / "q.fa")
    with open(q, "w") as f:
        for i, s in enumerate(queries):
            f.write(f">q{i} query, {i}\n{s.decode()}\n")
    return q, t


def _port(d, settings, shared_target=False, group_by_pair=True, seed=3, target_index=True):
    """Both indexes, the manysearch rows, both sidecars and the stitched
    products of the port on the CPU; without ``target_index`` the target
    sidecar's hash index is removed before the stitch."""
    q, t = _corpus(d, seed, shared_target)
    cfg = IndexConfig(settings[1], settings[2], settings[0])
    query = ProteomeIndex.build(q, cfg, store_raw_sequences=True, device="cpu")
    target = ProteomeIndex.build(t, cfg, store_raw_sequences=True, device="cpu")
    rows = manysearch(query, target)
    paths = {p: str(d / p) for p in ("q.kmers.pq", "t.kmers.pq", "s.csv", "report.txt")}
    kmers.write_kmer_table_for_index(query, paths["q.kmers.pq"])
    kmers.write_kmer_table_for_index(target, paths["t.kmers.pq"])
    if not target_index:
        os.remove(kmers.kmer_hash_index_filename(paths["t.kmers.pq"]))
    _, counts = stitch.write_stitched(rows, paths["q.kmers.pq"], paths["t.kmers.pq"], paths["s.csv"],
                                      paths["report.txt"], group_by_pair=group_by_pair)
    return q, t, rows, paths, counts


def _checks(q, t, paths, settings, group_by_pair):
    """The benchmark's check numbers of the port's products."""
    moltype, k, scaled = settings
    qw = ref.kept_windows(q, k, scaled, moltype)
    tw = ref.kept_windows(t, k, scaled, moltype)
    want_rows, want_report = ref.stitch(qw, tw, k, group_by_pair)
    out = ref.compare_sidecar(paths["q.kmers.pq"], ref.sidecar_columns(qw, k, os.path.abspath(q)))
    out.update(ref.compare_stitched(paths["s.csv"], want_rows))
    out.update(ref.compare_report(paths["report.txt"], want_report))
    assert set(out) == set(CHECKS)
    return out, want_rows


@pytest.mark.parametrize("settings", SETTINGS)
def test_block_sidecar_equals_the_reference_row_for_row(tmp_path, settings):
    q, t, _rows, paths, _ = _port(tmp_path, settings)
    moltype, k, scaled = settings
    for fasta, pq_path in ((q, paths["q.kmers.pq"]), (t, paths["t.kmers.pq"])):
        want = ref.sidecar_columns(ref.kept_windows(fasta, k, scaled, moltype), k, os.path.abspath(fasta))
        got = pq.read_table(pq_path)
        assert got.column_names == ref.SIDECAR_COLUMNS and len(got) > 0
        assert got.to_pydict() == want


def _target_scan_counts(since):
    """The counters of the last ``stitch.scan`` span after ``since``: the
    target side's."""
    return [r for r in metrics.records(since=since) if r.name == "stitch.scan"][-1].counts


def _since():
    return metrics.records()[-1].t1 if metrics.records() else 0.0


@pytest.mark.parametrize("settings", SETTINGS)
@pytest.mark.parametrize("group_by_pair", [True, False])
@pytest.mark.parametrize("target_index", [True, False], ids=["indexed", "scanned"])
def test_stitched_csv_and_report_equal_the_reference(tmp_path, settings, group_by_pair, target_index):
    # the shared target is planted only where rows are grouped per pair:
    # grouped by match name, its two queries' k-mers trip kmerseek's assertion
    since = _since()
    q, t, rows, paths, counts = _port(tmp_path, settings, shared_target=group_by_pair,
                                      group_by_pair=group_by_pair, target_index=target_index)
    target_counts = _target_scan_counts(since)
    assert target_counts["stitch.index_probes" if target_index else "stitch.index_fallbacks"] == 1
    assert target_counts["stitch.groups_decoded"] == int(not target_index)
    out, want = _checks(q, t, paths, settings, group_by_pair)
    assert out == dict.fromkeys(CHECKS, 0)
    assert len(want) >= 4 and counts.segments == len(want)
    got = pq.read_table(paths["q.kmers.pq"])
    assert counts.rows_scanned == len(got) + len(pq.read_table(paths["t.kmers.pq"]))
    if group_by_pair:
        names = {r["match_name"] for r in want}
        assert len(names) < len(want)  # one target matched by two queries: two rows


@pytest.mark.parametrize("group_by_pair", [False, True])
@pytest.mark.parametrize("target_index", [True, False], ids=["indexed", "scanned"])
def test_write_stitched_writes_the_bytes_of_the_former_cli_tail(tmp_path, capsys, group_by_pair, target_index):
    """The tail ``search --extract-kmers`` ran inline before
    ``write_stitched``: the streaming stitch, ``click.echo`` of the
    report to stderr, the CSV to stdout (or a file); with and without
    the target sidecar's hash index."""
    _q, _t, rows, paths, _ = _port(tmp_path, SETTINGS[0], shared_target=group_by_pair,
                                   group_by_pair=group_by_pair, target_index=target_index)
    assert os.path.exists(kmers.kmer_hash_index_filename(paths["t.kmers.pq"])) == target_index
    capsys.readouterr()
    stitched, report = stitch.stitch_results_streaming(rows, paths["q.kmers.pq"], paths["t.kmers.pq"],
                                                       group_by_pair=group_by_pair)
    click.echo(report, err=True)
    data = stitch.stitched_to_csv(stitched)
    print(data, end="")
    former = capsys.readouterr()
    frame, _ = stitch.write_stitched(rows, paths["q.kmers.pq"], paths["t.kmers.pq"],
                                     group_by_pair=group_by_pair)
    now = capsys.readouterr()
    assert now.out == former.out and now.err == former.err and former.out.count("\n") >= 4
    assert frame.equals(stitched)
    with open(paths["s.csv"]) as f:
        assert f.read() == data
    with open(paths["report.txt"]) as f:
        assert f.read() == former.err


@pytest.mark.parametrize("block", ["per_pair", "by_match_name", "no_rows"])
def test_write_stitched_reads_search_rows_as_their_list(tmp_path, block):
    """``write_stitched`` from the ``SearchRows`` that ``manysearch``
    returns and from the list of its row dicts: the same frame, counts,
    CSV and report; a block with no rows writes the header-only CSV the
    reference expects."""
    group_by_pair = block != "by_match_name"
    _q, _t, rows, paths, _ = _port(tmp_path, SETTINGS[0], shared_target=group_by_pair,
                                   group_by_pair=group_by_pair)
    assert isinstance(rows, SearchRows) and len(rows) >= 4
    if block == "no_rows":
        rows = SearchRows({c: [] for c in MANYSEARCH_COLUMNS})
    got = {}
    for kind, given in (("rows", rows), ("list", list(rows))):
        csv_p, rep_p = str(tmp_path / f"{kind}.csv"), str(tmp_path / f"{kind}.txt")
        frame, counts = stitch.write_stitched(given, paths["q.kmers.pq"], paths["t.kmers.pq"], csv_p, rep_p,
                                              group_by_pair=group_by_pair)
        with open(csv_p) as f, open(rep_p) as g:
            got[kind] = (frame, counts, f.read(), g.read())
    assert got["rows"][0].equals(got["list"][0]) and got["rows"][1:] == got["list"][1:]
    if block == "no_rows":
        assert got["rows"][2] == ",".join(stitch.STITCH_COLUMNS) + "\n" and got["rows"][3] == "\n"
        assert ref.compare_stitched(str(tmp_path / "rows.csv"), []) == {"stitched_rows_off": 0,
                                                                       "stitched_cells_off": 0}
    else:
        with open(paths["s.csv"]) as f:
            assert got["rows"][2] == f.read() and got["rows"][2].count("\n") >= 5


def test_spans_nest_under_stitch_write_and_kmers_extract(tmp_path):
    since = metrics.records()[-1].t1 if metrics.records() else 0.0
    q, t, _rows, paths, counts = _port(tmp_path, SETTINGS[0])
    recs = metrics.records(since=since)
    by_id = {r.span_id: r for r in recs}
    parent = lambda r: by_id[r.parent_id].name if r.parent_id in by_id else None  # noqa: E731
    names = {r.name for r in recs}
    assert {"kmers.extract", "kmers.hash", "kmers.strings", "kmers.write", "kmers.index", "stitch.write",
            "stitch.scan", "stitch.join", "stitch.segments", "stitch.csv"} <= names
    for r in recs:
        if r.name in ("kmers.hash", "kmers.strings", "kmers.write", "kmers.index"):
            assert parent(r) == "kmers.extract"
        if r.name in ("stitch.scan", "stitch.join", "stitch.segments", "stitch.csv"):
            assert parent(r) == "stitch.write"
    extracts = [r for r in recs if r.name == "kmers.extract"]
    assert [r.counts["kmers.rows"] for r in extracts] == [
        len(pq.read_table(paths["q.kmers.pq"])), len(pq.read_table(paths["t.kmers.pq"]))]
    scans = [r for r in recs if r.name == "stitch.scan"]
    assert len(scans) == 2 and len([r for r in recs if r.name == "stitch.write"]) == 1
    assert scans[1].counts["stitch.rows_scanned"] == len(pq.read_table(paths["t.kmers.pq"]))
    assert scans[0].counts["stitch.rows_scanned"] == len(pq.read_table(paths["q.kmers.pq"]))
    assert sum(r.counts["stitch.rows_kept"] for r in scans) == counts.rows_kept
    # the query side has no hash probe: every row is a hit
    assert scans[0].counts["stitch.hash_hits"] == scans[0].counts["stitch.rows_scanned"]
    q_table = pq.read_table(paths["q.kmers.pq"]).to_pandas()
    q_hashes = q_table.loc[q_table["sequence_name"].isin({r["query_name"] for r in _rows}), "hashval"]
    t_hashes = pq.read_table(paths["t.kmers.pq"]).column("hashval").to_numpy()
    assert scans[1].counts["stitch.hash_hits"] == np.isin(t_hashes, q_hashes.to_numpy()).sum()
    assert scans[1].counts["stitch.rows_kept"] <= scans[1].counts["stitch.hash_hits"]
    # one row group a sidecar, with kept rows in each; the target's rows come
    # from its hash index, which decodes no group; the query side has no probe
    assert pq.ParquetFile(paths["t.kmers.pq"]).num_row_groups == 1
    assert [r.counts["stitch.groups_decoded"] for r in scans] == [1, 0]
    assert scans[1].counts["stitch.index_probes"] == 1 and "stitch.index_fallbacks" not in scans[1].counts
    assert not {"stitch.index_probes", "stitch.index_fallbacks"} & set(scans[0].counts)
    (seg,) = [r for r in recs if r.name == "stitch.segments"]
    assert seg.counts == {"stitch.segments": counts.segments}
    # on the CPU no host wait is on a CUDA tensor
    assert not any("device.syncs" in (r.counts or {}) for r in recs)


def _rewrite_sidecar(path, **change):
    table = pq.read_table(path).to_pydict()
    for col, fn in change.items():
        table[col] = fn(table[col])
    pq.write_table(pa.Table.from_pydict(table, schema=kmers.KMERS_SCHEMA), path)


def _plant(fault, q, rows, paths, settings):
    moltype, k, scaled = settings
    if fault == "grouped by match name":
        stitch.write_stitched(rows, paths["q.kmers.pq"], paths["t.kmers.pq"], paths["s.csv"],
                              paths["report.txt"], group_by_pair=False)
        return
    if fault == "start shifted by one":  # the unrelated query's last window, which joins nothing
        _rewrite_sidecar(paths["q.kmers.pq"], start=lambda s: s[:-1] + [s[-1] + 1])
    elif fault == "sidecar row dropped":
        table = pq.read_table(paths["q.kmers.pq"])
        pq.write_table(table.slice(1), paths["q.kmers.pq"])
    elif fault == "hashval through float64":
        qw = ref.kept_windows(q, k, scaled, moltype, hash_dtype=np.float64)
        cols = ref.sidecar_columns(qw, k, os.path.abspath(q))
        pq.write_table(pa.Table.from_pydict(cols, schema=kmers.KMERS_SCHEMA), paths["q.kmers.pq"])
    stitch.write_stitched(rows, paths["q.kmers.pq"], paths["t.kmers.pq"], paths["s.csv"],
                          paths["report.txt"], group_by_pair=True)


@pytest.mark.parametrize("fault", ["grouped by match name", "start shifted by one", "sidecar row dropped",
                                   "hashval through float64"])
def test_planted_fault_reads_not_correct(tmp_path, fault):
    settings = SETTINGS[1]
    q, t, rows, paths, _ = _port(tmp_path, settings, shared_target=True)
    assert _checks(q, t, paths, settings, True)[0] == dict.fromkeys(CHECKS, 0)
    _plant(fault, q, rows, paths, settings)
    out, _ = _checks(q, t, paths, settings, True)
    assert any(v > 0 for v in out.values()), out


def _former_scan(path, names, hash_filter=None, batch_rows=1 << 16):
    """The sidecar scan before the hash probe came first, kept as the
    plain oracle of ``stitch._scan_kmer_parquet``: each batch's names as
    Python strings tested against the set, then its hashes by
    ``searchsorted``, then the whole batch to pandas and the mask."""
    pf = pq.ParquetFile(path)
    kept, scanned = [], 0
    for batch in pf.iter_batches(batch_size=batch_rows):
        name_col = batch.column("sequence_name").to_numpy(zero_copy_only=False)
        mask = np.fromiter((n in names for n in name_col), count=len(name_col), dtype=bool)
        if hash_filter is not None and mask.any():
            if len(hash_filter) == 0:
                mask[:] = False
            else:
                hv = batch.column("hashval").to_numpy(zero_copy_only=False)
                pos = np.searchsorted(hash_filter, hv)
                pos[pos == len(hash_filter)] = 0
                mask &= hash_filter[pos] == hv
        scanned += len(name_col)
        if mask.any():
            kept.append(batch.to_pandas().loc[mask])
    if not kept:
        return pd.DataFrame(columns=ref.SIDECAR_COLUMNS), scanned
    return pd.concat(kept, ignore_index=True), scanned


def _synthetic_sidecar(path, n_rows, group_rows, seed, high_hashes=False, string_type=pa.large_string(),
                       use_dictionary=True, shared=(), compression="snappy"):
    """A sidecar of ``n_rows`` rows in row groups of ``group_rows``: 40
    UniProt-style names in runs, as the rows of one sequence are, random
    24-mers and uint64 hashes (all ≥ 2^63 with ``high_hashes``, the
    largest planted; with ``shared`` offsets, rows ``SHARED_BASES + offset``
    take the hash of their base row, as hp and dayhoff collisions do).
    Returns the hashes and the 40 names."""
    rng = np.random.default_rng(seed)
    names = np.array([f"sp|P{i:05d}|T{i}_HUMAN target {i}" for i in range(40)], dtype=object)
    seq = np.sort(rng.integers(0, 40, size=n_rows))
    kmer = AA[rng.integers(0, 20, size=(n_rows, 24))].view("S24").ravel().astype(str)
    low = 1 << 63 if high_hashes else 0
    hashes = rng.integers(low, 1 << 64, size=n_rows, dtype=np.uint64, endpoint=False)
    if high_hashes:
        hashes[: min(n_rows, 3)] = [(1 << 64) - 1, 1 << 63, (1 << 64) - 2][: min(n_rows, 3)]
    for off in shared:
        hashes[SHARED_BASES + off] = hashes[SHARED_BASES]
    starts = np.arange(n_rows, dtype=np.uint32) % 997
    schema = pa.schema([(c, string_type if t == pa.large_string() else t) for c, t in
                        zip(kmers.KMERS_SCHEMA.names, kmers.KMERS_SCHEMA.types)])
    table = pa.Table.from_arrays(
        [pa.array(np.full(n_rows, "/data/t.fa", dtype=object), string_type), pa.array(names[seq], string_type),
         pa.array(kmer, string_type), pa.array(hashes, pa.uint64()), pa.array(np.char.lower(kmer), string_type),
         pa.array(starts, pa.uint32())], schema=schema)
    pq.write_table(table, path, row_group_size=group_rows, use_dictionary=use_dictionary, compression=compression)
    return hashes, names


SHARED_BASES = np.arange(8) * 11 + 5


def _write_hash_index(path, chunk_rows=100):
    """The hash index of the sidecar ``path``, written by the sidecar
    writer's index writer from the file's rows in chunks of ``chunk_rows``."""
    with kmers._HashIndexWriter(path, 24) as writer:
        for batch in pq.ParquetFile(path).iter_batches(batch_size=chunk_rows):
            writer.add(pa.Table.from_batches([batch]))
        writer.finish(path)


def _filter_case(case, hashes, names, group_rows, rng):
    """(names, hash_filter) of one scan case."""
    some_names = set(names[::2].tolist())
    drawn = hashes[rng.choice(len(hashes), size=min(40, len(hashes)), replace=False)]
    absent = rng.integers(0, 1 << 64, size=10, dtype=np.uint64, endpoint=False)
    if case == "query side":
        return some_names, None
    if case == "empty hash filter":
        return set(names.tolist()), np.zeros(0, dtype=np.uint64)
    if case == "no matching name":
        return {"sp|Q99999|NONE_HUMAN"}, np.unique(drawn)
    if case == "no survivor":
        return set(names.tolist()), np.unique(np.setdiff1d(absent, hashes))
    if case == "one group survives":
        return set(names.tolist()), np.unique(hashes[3 * group_rows + 5: 3 * group_rows + 25])
    if case == "equal hashes, other names":
        return set(names.tolist()), np.unique(np.concatenate([hashes[SHARED_BASES], absent]))
    if case == "one hash in several row groups":
        return some_names, np.unique(hashes[SHARED_BASES])
    return some_names, np.unique(np.concatenate([drawn, hashes[:3], absent]))


SCAN_CASES = {  # id: (rows, row group rows, batch_rows, sidecar options)
    "one row group": (700, 1 << 20, 1 << 16, {}),
    "64-row groups": (1000, 64, 64, {}),
    "a 2^18-row group": ((1 << 18) + 300, 1 << 18, 1 << 16, {}),
    "hashes >= 2^63": (900, 64, 64, {"high_hashes": True}),
    "empty hash filter": (500, 64, 64, {}),
    "no matching name": (500, 64, 64, {}),
    "one group survives": (1000, 64, 64, {}),
    "no survivor": (500, 64, 64, {}),
    "no dictionary encoding": (1000, 64, 64, {"use_dictionary": False}),
    "string columns": (1000, 64, 64, {"string_type": pa.string()}),
    "query side": (1000, 64, 64, {}),
    # one row group; the rows sharing a hash lie 30 and 60 rows apart, under other names
    "equal hashes, other names": (1000, 1 << 20, 1 << 16, {"shared": (30, 60)}),
    # rows sharing a hash in four row groups, some under one name
    "one hash in several row groups": (1000, 64, 64, {"shared": (3, 64, 130, 700)}),
}


@pytest.mark.parametrize("indexed", [False, True], ids=["scanned", "indexed"])
@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_scan_equals_the_former_scan(tmp_path, case, indexed):
    n_rows, group_rows, batch_rows, opts = SCAN_CASES[case]
    path = str(tmp_path / "s.kmers.pq")
    seed = 11 + list(SCAN_CASES).index(case)
    hashes, names = _synthetic_sidecar(path, n_rows, group_rows, seed, **opts)
    if indexed:
        _write_hash_index(path)
    want_names, hash_filter = _filter_case(case, hashes, names, group_rows, np.random.default_rng(seed))
    want, want_scanned = _former_scan(path, want_names, hash_filter, batch_rows)
    since = _since()
    got, scanned = stitch._scan_kmer_parquet(path, want_names, hash_filter, batch_rows)
    (rec,) = [r for r in metrics.records(since=since) if r.name == "stitch.scan"]
    assert got.equals(want) and list(got.dtypes) == list(want.dtypes) and list(got.columns) == list(want.columns)
    assert scanned == want_scanned == n_rows
    # the counters, each from the file's whole table
    table = pq.read_table(path).to_pandas()
    in_hashes = np.ones(n_rows, bool) if hash_filter is None else np.isin(hashes, hash_filter)
    kept_rows = np.flatnonzero(in_hashes & table["sequence_name"].isin(want_names).to_numpy())
    probed = indexed and hash_filter is not None  # the query side has no hash filter: always scanned
    groups = 0 if probed else len(set(kept_rows // group_rows))
    index_counter = {} if hash_filter is None else {"stitch.index_probes" if probed else "stitch.index_fallbacks": 1}
    assert rec.counts == {"stitch.rows_scanned": n_rows, "stitch.hash_hits": in_hashes.sum(),
                          "stitch.rows_kept": len(want), "stitch.groups_decoded": groups, **index_counter}
    assert rec.counts["stitch.hash_hits"] <= rec.counts["stitch.rows_scanned"] and len(kept_rows) == len(want)
    if case in ("empty hash filter", "no matching name", "no survivor"):
        assert len(want) == 0 and rec.counts["stitch.groups_decoded"] == 0
    else:
        assert len(want) > 0
    if case == "one group survives":
        assert rec.counts["stitch.groups_decoded"] == int(not probed)
    if case == "no matching name":
        assert rec.counts["stitch.hash_hits"] > 0
    if case == "hashes >= 2^63":  # the first target's rows, 2^64 - 1 and 2^63 among them
        assert want["hashval"].min() >= 1 << 63 and (1 << 64) - 1 in set(want["hashval"].tolist())
    if opts.get("shared"):  # every shared hash fans out to rows under more than one name
        assert len(want) > len(np.intersect1d(hash_filter, hashes))
        rows_of = table.iloc[np.flatnonzero(np.isin(hashes, hashes[SHARED_BASES]))]
        assert (rows_of.groupby("hashval")["sequence_name"].nunique() > 1).all()
    if case == "one hash in several row groups":
        sets = [set(np.flatnonzero(hashes == h) // group_rows) for h in hashes[SHARED_BASES]]
        assert all(len(g) >= 3 for g in sets)


def _stale(path, how):
    """Leave the sidecar ``path`` as ``how`` says: without an index, or
    with one that no longer describes it."""
    index = kmers.kmer_hash_index_filename(path)
    if how == "no index":
        return
    _write_hash_index(path)
    st = os.stat(path)
    if how == "rewritten, other size":
        table = pq.read_table(path)
        pq.write_table(table.slice(1), path, row_group_size=64)
        assert os.stat(path).st_size != st.st_size
    elif how == "same size, later mtime":
        os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))
    elif how == "same size and mtime, other bytes":
        # uncompressed and plain: a hash of the last row group changed in place,
        # inside its group's range, keeps the size; the index's digest of the
        # file's last bytes differs
        table = pq.read_table(path).to_pydict()
        last = table["hashval"][-40:]
        h = sorted(last)
        i = len(table["hashval"]) - 40 + last.index(h[20])
        table["hashval"][i] = (h[20] + h[21]) // 2
        pq.write_table(pa.Table.from_pydict(table, schema=kmers.KMERS_SCHEMA), path, row_group_size=64,
                       use_dictionary=False, compression="none")
        os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))
        assert os.stat(path).st_size == st.st_size and os.stat(path).st_mtime_ns == st.st_mtime_ns
    elif how == "truncated index":
        with open(index, "r+b") as f:
            f.truncate(os.path.getsize(index) - 8)
    elif how == "unknown version":
        with open(index, "r+b") as f:
            f.seek(len(kmers.HASH_INDEX_MAGIC))
            f.write(np.uint32(kmers.HASH_INDEX_VERSION + 1).tobytes())


@pytest.mark.parametrize("how", ["no index", "rewritten, other size", "same size, later mtime",
                                 "same size and mtime, other bytes", "truncated index", "unknown version"])
def test_scan_falls_back_where_the_index_does_not_match(tmp_path, how):
    path = str(tmp_path / "s.kmers.pq")
    hashes, names = _synthetic_sidecar(path, 1000, 64, 5, use_dictionary=False, compression="none")
    _stale(path, how)
    want_names = set(names[::2].tolist())
    hash_filter = np.unique(hashes[::7])
    want, _ = _former_scan(path, want_names, hash_filter)
    since = _since()
    got, scanned = stitch._scan_kmer_parquet(path, want_names, hash_filter)
    (rec,) = [r for r in metrics.records(since=since) if r.name == "stitch.scan"]
    assert got.equals(want) and list(got.dtypes) == list(want.dtypes) and len(want) > 0
    assert scanned == pq.ParquetFile(path).metadata.num_rows
    assert rec.counts["stitch.index_fallbacks"] == 1 and rec.counts.get("stitch.index_probes", 0) == 0
    assert rec.counts["stitch.groups_decoded"] > 0
    assert kmers.open_hash_index(path) is None


@pytest.mark.parametrize("settings", SETTINGS)
def test_indexed_scan_of_the_sidecar_writers_sidecar_equals_the_former_scan(tmp_path, monkeypatch, settings):
    """The sidecar writer's own sidecar and index, in several row groups
    and index chunks: the probe keeps the rows the former scan keeps, for
    every target name and for a third of them."""
    monkeypatch.setattr(kmers, "KMERS_ROW_GROUP", 97)
    batches = kmers.iter_kmer_batches
    monkeypatch.setattr(kmers, "iter_kmer_batches", lambda *a, **kw: batches(*a, **{**kw, "batch_rows": 7}))
    q, t, rows, paths, _ = _port(tmp_path, settings)
    path = paths["t.kmers.pq"]
    assert pq.ParquetFile(path).num_row_groups > 3
    table = pq.read_table(path).to_pandas()
    q_hashes = np.unique(pq.read_table(paths["q.kmers.pq"]).column("hashval").to_numpy())
    all_names = set(table["sequence_name"])
    for names in (all_names, set(sorted(all_names)[::3]) | {r["match_name"] for r in rows}):
        want, _ = _former_scan(path, names, q_hashes)
        since = _since()
        got, scanned = stitch._scan_kmer_parquet(path, names, q_hashes)
        (rec,) = [r for r in metrics.records(since=since) if r.name == "stitch.scan"]
        assert rec.counts["stitch.index_probes"] == 1 and rec.counts["stitch.groups_decoded"] == 0
        assert got.equals(want) and list(got.dtypes) == list(want.dtypes) and len(want) > 0
        assert scanned == len(table)


@pytest.mark.parametrize("settings", SETTINGS)
def test_sidecar_parquet_is_the_bytes_written_without_the_index(tmp_path, monkeypatch, settings):
    """The index changes nothing in the parquet: the sidecar writer's file
    equals, byte for byte, the one it writes with the index writer taken
    out."""
    q, _t, _rows, paths, _ = _port(tmp_path, settings)
    query = ProteomeIndex.build(q, IndexConfig(settings[1], settings[2], settings[0]), store_raw_sequences=True,
                                device="cpu")

    class NoIndex:
        def __init__(self, path, k):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            pass

        def add(self, chunk):
            pass

        def finish(self, parquet_path):
            pass

    monkeypatch.setattr(kmers, "_HashIndexWriter", NoIndex)
    plain = str(tmp_path / "plain.kmers.pq")
    kmers.write_kmer_table_for_index(query, plain)
    with open(plain, "rb") as f, open(paths["q.kmers.pq"], "rb") as g:
        assert f.read() == g.read()
    assert not os.path.exists(kmers.kmer_hash_index_filename(plain))
    assert kmers.open_hash_index(paths["q.kmers.pq"]) is not None
