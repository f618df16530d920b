"""A CPU rehearsal of the Swiss-Prot-sized search cell, small: the
requests, the spans, the chunked check and the result line; the cell
taken by the harness as it is, from new files and entries alone; and the
precision control (``kbench/control_chunked.py``) and faults planted in
the timed path reading not correct."""

import json
import os
import shutil
from unittest import mock

import pytest
from conftest import ROOT, SMALL, spec
from test_kbench_cells import TOP, _run
from test_kbench_control import _search_faults

from kbench import control_chunked, harness

CELL = "hp24-swissprot-search-b128"
SPEC = spec()
NEW = {"configs/hp-k24-s5-swissprot.json", "traffic/query_blocks_b128_swissprot.json",
       "kinds/search_blocks_chunked.py", "reference/sketch_chunked.py", "control_chunked.py",
       "metrics/host_join_ns_per_tuple.search.py", "metrics/cross_check_ns_per_tuple.search.py",
       "metrics/target_metadata_ms_per_kentry.search.py"}
NEW_METRICS = {"host_join_ns_per_tuple.search", "cross_check_ns_per_tuple.search",
               "target_metadata_ms_per_kentry.search"}


def test_swissprot_cell_rehearsal_is_correct(tmp_path):
    run, out = _run(tmp_path, CELL)
    assert list(out) == TOP + ["checks"]
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    e2e = {m["name"] for m in SPEC["end_to_end"] if CELL in m.get("workloads", [CELL])}
    assert set(out["metrics"]) == e2e and {"search_queries_per_s", "setup_s"} <= e2e
    assert set(out["checks"]) == {"rows_off", "exact_cells_off", "float_rel_err"}
    assert {k: c["limit"] for k, c in out["checks"].items()} == {
        "rows_off": 0, "exact_cells_off": 0, "float_rel_err": 1e-9}
    assert run.checked_requests and run.checked_requests[-1] == run.records[-1][0]
    json.dumps(out)


def test_swissprot_cell_traced_rehearsal_reads_the_new_metrics(tmp_path):
    run, out = _run(tmp_path, CELL, trace=True)
    assert out["correct"]
    listed = {m["name"] for m in SPEC["per_layer"] if CELL in m["workloads"]}
    assert NEW_METRICS <= listed and "row_dicts_ms_per_block.search" not in listed
    # the CPU has no device trace: only the host-clock and program spans can be read
    assert set(out["metrics"]) == {n for n in listed if "_ms_per_" in n or "_ns_per_" in n}
    assert all(v["value"] > 0 for v in out["metrics"].values())


def test_swissprot_cell_taken_from_new_files_and_entries(tmp_path):
    """The harness as it is finds the cell's configuration, traffic, kind
    and metric readers by name among the new files, and the run leaves
    every other file of ``kbench/`` as it was."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "kbench"), root / "kbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    files = {os.path.relpath(os.path.join(d, f), root / "kbench")
             for d, _, fs in os.walk(root / "kbench") for f in fs}
    assert NEW <= files
    before = {p: (root / "kbench" / p).read_bytes() for p in files - NEW}
    run, out = _run(tmp_path, CELL, trace=True, root=str(root))
    assert out["correct"] and NEW_METRICS <= set(out["metrics"])
    assert run.kind.__spec__.origin == str(root / "kbench" / "kinds" / "search_blocks_chunked.py")
    for name in NEW_METRICS:
        assert harness.metric_reader(str(root), name).__spec__.origin == str(root / "kbench" / "metrics" / f"{name}.py")
    assert {p: (root / "kbench" / p).read_bytes() for p in files - NEW} == before


def test_swissprot_precision_control_is_not_correct(tmp_path):
    run = harness.Run(SPEC, CELL, 3, 0.5, False, "cpu", str(tmp_path), SMALL)
    with control_chunked.patched(run):
        out = harness.run_cell(run)
    assert not out["correct"] and out["failed"] == 0
    assert out["checks"]["float_rel_err"]["value"] > 1e-9


def _faults():
    from kmerseek_tpu_torch.core import search

    orig = search.manysearch

    def altered(query, target, threshold=0.0):
        rows = orig(query, target, threshold)
        n = rows.columns["intersect_hashes"].copy()
        n[len(n) // 2] += 1
        return search.SearchRows(dict(rows.columns, intersect_hashes=n))

    faults = _search_faults()
    faults["altered"] = mock.patch.object(search, "manysearch", altered)
    return faults


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_swissprot_fault_in_the_timed_path_is_not_correct(tmp_path, fault):
    with _faults()[fault]:
        run, out = _run(tmp_path, CELL)
    assert not out["correct"], out["checks"]
