"""The port's span and counter registry (``kmerseek_tpu_torch.utils.metrics``)
and the spans on its index and search paths, on the CPU: nesting, trace
ids, self time, the reading thread's parent, the exception mark, the
ring's bound, counters on the innermost span, ``record_function`` only
under a profiler, the ranges in a ``device_profile`` Chrome trace, and
the spans one query block records."""

import csv
import glob
import json
import os
import sys
import threading
import time
from collections import Counter
from unittest import mock

import numpy as np
import pytest
import torch

from kmerseek_tpu_torch import native
from kmerseek_tpu_torch.core.fasta import prefetch
from kmerseek_tpu_torch.core.index import IndexConfig, ProteomeIndex
from kmerseek_tpu_torch.core.search import MANYSEARCH_COLUMNS, manysearch, write_search_csv
from kmerseek_tpu_torch.utils import metrics
from test_torch_index import write_fasta

CFG = IndexConfig(16, 5, "hp")
# the spans of one query block: index.read also times the wait that finds
# the end of the file, index.finalize also ``from_signatures``
BLOCK_SPANS = {
    "index.build": 1, "index.read": 2, "fasta.read": 2, "index.validate": 1,
    "index.sketch_device": 1, "index.finalize": 2, "search.manysearch": 1, "search.join": 1,
    "search.columns": 1, "search.cross_check": 1, "search.csv": 1,
}


@pytest.fixture
def fastas(tmp_path):
    write_fasta(str(tmp_path / "t.fa"), n=40, seed=5, max_len=400)
    with open(tmp_path / "t.fa") as src, open(tmp_path / "q.fa", "w") as dst:
        dst.write("".join(src.readlines()[:50]))
    return str(tmp_path / "q.fa"), str(tmp_path / "t.fa")


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def test_spans_nest_share_a_trace_id_and_give_self_time():
    reg = metrics.Registry()
    with reg.span("a") as a:
        time.sleep(0.002)
        with reg.span("b") as b:
            time.sleep(0.003)
        with reg.span("c") as c:
            with reg.span("d") as d:
                time.sleep(0.001)
    with reg.span("e") as e:
        pass
    recs = {r.name: r for r in reg.records()}
    assert [r.name for r in reg.records()] == ["b", "d", "c", "a", "e"]  # recorded as they end
    assert (recs["a"].parent_id, recs["b"].parent_id, recs["c"].parent_id) == (0, a.span_id, a.span_id)
    assert recs["d"].parent_id == c.span_id
    assert {recs[n].trace_id for n in "abcd"} == {a.span_id}
    assert recs["e"].trace_id == e.span_id != a.span_id and recs["e"].parent_id == 0
    assert len({r.thread for r in recs.values()}) == 1 and not any(r.error for r in recs.values())
    st = metrics.self_times(reg.records())
    dur = {n: recs[n].t1 - recs[n].t0 for n in recs}
    assert st[a.span_id] == pytest.approx(dur["a"] - dur["b"] - dur["c"], abs=1e-12)
    assert st[c.span_id] == pytest.approx(dur["c"] - dur["d"], abs=1e-12)
    assert st[b.span_id] == dur["b"] and st[d.span_id] == dur["d"]
    assert st[a.span_id] >= 0.0019
    assert (a.t0, a.t1) == (recs["a"].t0, recs["a"].t1) and b.seconds == dur["b"]


def test_counters_attach_to_the_innermost_span_and_keep_totals():
    reg = metrics.Registry()
    reg.count("rows", 5)  # no span open: the totals only
    with reg.span("outer"):
        reg.count("rows", 2)
        with reg.span("inner"):
            reg.count("rows", 3)
            reg.count("syncs")
        reg.count("syncs")
    recs = {r.name: r for r in reg.records()}
    assert recs["inner"].counts == {"rows": 3, "syncs": 1}
    assert recs["outer"].counts == {"rows": 2, "syncs": 1}
    assert reg.counters() == {"rows": 10, "syncs": 2}


def test_a_span_left_by_an_exception_is_recorded_and_marked():
    reg = metrics.Registry()
    with pytest.raises(ValueError):
        with reg.span("outer"):
            with reg.span("inner"):
                raise ValueError("x")
    with reg.span("after") as after:
        pass
    recs = {r.name: r for r in reg.records()}
    assert recs["inner"].error and recs["outer"].error and not recs["after"].error
    assert recs["inner"].parent_id == recs["outer"].span_id
    assert after.parent_id == 0  # the stack was unwound
    assert reg.span_totals()["inner"][0] == 1


def test_the_ring_keeps_the_newest_spans_and_counts_what_it_drops():
    reg = metrics.Registry(ring_spans=4)
    for i in range(10):
        with reg.span(f"s{i}"):
            reg.count("n")
    assert [r.name for r in reg.records()] == ["s6", "s7", "s8", "s9"]
    assert reg.dropped == 6
    assert sum(n for n, _ in reg.span_totals().values()) == 10 and reg.counters() == {"n": 10}
    cut = reg.records()[2].t0
    assert [r.name for r in reg.records(since=cut)] == ["s8", "s9"]


def test_prefetch_reads_are_children_of_the_span_that_started_them():
    t = time.perf_counter()
    with metrics.span("starter") as starter:
        got = list(prefetch(iter([1, 2, 3])))
        with metrics.span("sibling"):
            pass
    assert got == [1, 2, 3]
    recs = [r for r in metrics.records(since=t)]
    reads = [r for r in recs if r.name == "fasta.read"]
    assert len(reads) == 4  # three items and the end of the iterable
    assert all(r.parent_id == starter.span_id and r.trace_id == starter.trace_id for r in reads)
    assert {r.thread for r in reads} != {threading.get_ident()}
    (rec,) = [r for r in recs if r.name == "starter"]
    (sib,) = [r for r in recs if r.name == "sibling"]
    # children on another thread run beside the span: not taken off its self time
    assert metrics.self_times(recs)[starter.span_id] == pytest.approx(
        rec.t1 - rec.t0 - (sib.t1 - sib.t0), abs=1e-12)


def test_prefetch_error_marks_the_read_and_reaches_the_consumer():
    def boom():
        yield 1
        raise OSError("disk")

    t = time.perf_counter()
    with pytest.raises(OSError, match="disk"):
        list(prefetch(boom()))
    reads = [r for r in metrics.records(since=t) if r.name == "fasta.read"]
    assert [r.error for r in reads] == [False, True]


def test_no_record_function_without_a_profiler():
    reg = metrics.Registry()
    with mock.patch("torch.profiler.record_function") as rf:
        with reg.span("quiet"):
            pass
        assert not rf.called
        with mock.patch.object(metrics, "_profiler_enabled", return_value=True):
            with reg.span("loud"):
                pass
    rf.assert_called_once_with("kmerseek/loud")
    assert rf.return_value.__enter__.called and rf.return_value.__exit__.called


def test_threads_keep_their_own_stacks_and_lose_no_count():
    reg = metrics.Registry()
    n_threads, n_iter = 3 * (os.cpu_count() or 2), 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_iter):
                with reg.span("outer"):
                    with reg.span("inner"):
                        reg.count("n")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    assert reg.counters() == {"n": n_threads * n_iter}
    recs = reg.records()
    assert len(recs) == 2 * n_threads * n_iter and len({r.span_id for r in recs}) == len(recs)
    by_id = {r.span_id: r for r in recs}
    for r in recs:
        if r.name == "inner":
            parent = by_id[r.parent_id]
            assert parent.name == "outer" and parent.thread == r.thread and r.counts == {"n": 1}
        else:
            assert r.parent_id == 0 and r.counts is None


def test_one_block_records_each_span_and_counts_its_rows(fastas, tmp_path):
    qfa, tfa = fastas
    target = ProteomeIndex.build(tfa, CFG, device="cpu")
    t = time.perf_counter()
    query = ProteomeIndex.build(qfa, CFG, device="cpu")
    rows = manysearch(query, target)
    out = str(tmp_path / "block.csv")
    write_search_csv(rows, MANYSEARCH_COLUMNS, out)
    recs = metrics.records(since=t)
    assert dict(Counter(r.name for r in recs)) == BLOCK_SPANS
    spans = _by_name(recs)
    with open(out) as f:
        data_lines = len(list(csv.reader(f))) - 1
    assert data_lines == len(rows) > 0
    native_rows = data_lines if native.available() else 0
    python_columns = 0 if native.available() else len(MANYSEARCH_COLUMNS)
    assert spans["search.csv"][0].counts == {
        "rows_written": data_lines, "csv.native_rows": native_rows, "csv.python_columns": python_columns}
    # the first block against a fresh target builds its per-target sums
    assert spans["search.columns"][0].counts == {"rows": data_lines, "search.target_sums": 1}
    with open(qfa) as f:
        residues = sum(len(line.strip()) for line in f if not line.startswith(">"))
    assert spans["index.validate"][0].counts == {"residues": residues}
    assert not any(r.error for r in recs)
    assert not any("device.syncs" in (r.counts or {}) for r in recs)  # no CUDA tensor on the CPU
    build, many = spans["index.build"][0], spans["search.manysearch"][0]
    for name in ("index.read", "index.validate", "index.sketch_device", "index.finalize", "fasta.read"):
        assert all(r.parent_id == build.span_id and r.trace_id == build.span_id for r in spans[name])
    for name in ("search.join", "search.columns"):
        assert spans[name][0].parent_id == many.span_id
    assert spans["search.cross_check"][0].parent_id == spans["search.columns"][0].span_id
    assert spans["search.cross_check"][0].trace_id == many.span_id


def _csv_span(rows, columns, out):
    """The one ``search.csv`` span that writing ``rows`` records, and
    whether any span recorded meanwhile is its child."""
    t = time.perf_counter()
    write_search_csv(rows, columns, out)
    recs = metrics.records(since=t)
    (sp,) = [r for r in recs if r.name == "search.csv"]
    return sp, any(r.parent_id == sp.span_id for r in recs)


def test_csv_counters_native_rows_and_python_columns(fastas, tmp_path, monkeypatch):
    """A block's rows go through the C++ library with no column formatted
    a value at a time; a float32 column is one Python column; without the
    library every column is, and no row is native. ``search.csv`` has no
    child span on any of these paths."""
    if not native.available():
        pytest.skip("no C++ compiler: the native CSV formatter is not built")
    qfa, tfa = fastas
    rows = manysearch(ProteomeIndex.build(qfa, CFG, device="cpu"), ProteomeIndex.build(tfa, CFG, device="cpu"))
    assert rows
    sp, child = _csv_span(rows, MANYSEARCH_COLUMNS, str(tmp_path / "a.csv"))
    assert sp.counts == {"rows_written": len(rows), "csv.native_rows": len(rows), "csv.python_columns": 0}
    assert not child
    as_f32 = [dict(r, jaccard=np.float32(r["jaccard"])) for r in rows]
    sp, child = _csv_span(as_f32, MANYSEARCH_COLUMNS, str(tmp_path / "b.csv"))
    assert sp.counts == {"rows_written": len(rows), "csv.native_rows": len(rows), "csv.python_columns": 1}
    assert not child
    monkeypatch.setattr(native, "available", lambda: False)
    sp, child = _csv_span(rows, MANYSEARCH_COLUMNS, str(tmp_path / "c.csv"))
    assert sp.counts == {"rows_written": len(rows), "csv.native_rows": 0,
                         "csv.python_columns": len(MANYSEARCH_COLUMNS)}
    assert not child
    with open(tmp_path / "a.csv", "rb") as a, open(tmp_path / "c.csv", "rb") as c:
        assert a.read() == c.read()


def test_save_load_and_sig_zip_spans(fastas, tmp_path):
    _qfa, tfa = fastas
    idx = ProteomeIndex.build(tfa, CFG, device="cpu")
    t = time.perf_counter()
    idx.save(str(tmp_path / "t.ksx"))
    ProteomeIndex.load(str(tmp_path / "t.ksx"), device="cpu")
    idx.to_sig_zip(str(tmp_path / "t.sig.zip"))
    spans = _by_name(metrics.records(since=t))
    (save,) = spans["index.save"]
    assert [r.parent_id for r in spans["index.postings"] + spans["index.members"]] == [save.span_id] * 2
    assert len(spans["index.load"]) == 1
    (sz,) = spans["sigzip.write"]
    assert sz.counts["signatures"] == len(idx)
    assert set(sz.counts) == {"signatures", "sigzip.md5_s", "sigzip.json_s", "sigzip.gzip_s", "sigzip.zip_s"}
    assert 0 < sum(v for k, v in sz.counts.items() if k.endswith("_s")) <= sz.t1 - sz.t0


def test_profiled_trace_nests_every_range_in_its_parent(fastas, tmp_path, caplog):
    """Under ``device_profile`` the spans of the main thread are
    ``kmerseek/`` ranges, each inside its parent's range; the span table
    is logged at the end."""
    qfa, tfa = fastas
    target = ProteomeIndex.build(tfa, CFG, device="cpu")
    trace_dir = str(tmp_path / "trace")
    caplog.set_level("INFO", logger="kmerseek_tpu_torch")
    t = time.perf_counter()
    with metrics.device_profile(trace_dir, "cpu"):
        query = ProteomeIndex.build(qfa, CFG, device="cpu")
        write_search_csv(manysearch(query, target), MANYSEARCH_COLUMNS, str(tmp_path / "p.csv"))
    me = threading.get_ident()
    recs = [r for r in metrics.records(since=t) if r.thread == me]
    (path,) = glob.glob(os.path.join(trace_dir, "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith("kmerseek/")]
    assert Counter(e["name"][len("kmerseek/"):] for e in ranges) == Counter(r.name for r in recs)
    names = {r.span_id: r.name for r in recs}
    for r in recs:
        if r.parent_id not in names:
            continue
        mine = [e for e in ranges if e["name"] == "kmerseek/" + r.name]
        parents = [e for e in ranges if e["name"] == "kmerseek/" + names[r.parent_id]]
        for e in mine:
            assert any(p["tid"] == e["tid"] and p["ts"] <= e["ts"]
                       and e["ts"] + e["dur"] <= p["ts"] + p["dur"] for p in parents), e
    table = [m.getMessage() for m in caplog.records if "spans of the profiled run" in m.getMessage()]
    assert len(table) == 1 and "search.manysearch" in table[0] and "index.build" in table[0]


def test_span_table_lists_counts_times_and_counters():
    reg = metrics.Registry()
    for _ in range(2):
        with reg.span("search.csv"):
            reg.count("rows_written", 3)
    with reg.span("index.build"):
        with reg.span("index.read"):
            pass
    lines = metrics.span_table(reg.records()).splitlines()
    assert lines[0].split() == ["span", "count", "total", "ms", "self", "ms", "counters"]
    rows = {line.split()[0]: line.split() for line in lines[1:]}
    assert set(rows) == {"search.csv", "index.build", "index.read"}
    assert rows["search.csv"][1] == "2" and rows["search.csv"][4:] == ["rows_written", "6"]
    assert float(rows["index.build"][2]) >= float(rows["index.build"][3])


def test_note_sync_counts_only_cuda_tensors():
    before = metrics.counters().get("device.syncs", 0)
    metrics.note_sync(torch.zeros(3))
    assert metrics.counters().get("device.syncs", 0) == before
    cuda_like = mock.Mock(is_cuda=True)
    metrics.note_sync(cuda_like)
    assert metrics.counters().get("device.syncs", 0) == before + 1
