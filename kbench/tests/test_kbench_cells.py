"""A CPU rehearsal of every cell, small: the requests, the spans, the
check and the result line; and a cell added as new files only."""

import json
import os
import shutil

import pytest
from conftest import CELLS, ROOT, SMALL, spec

from kbench import harness

SPEC = spec()
TOP = ["correct", "attempted", "failed", "metrics", "device"]


def _run(tmp_path, cell, trace=False, spec=SPEC, root=harness.ROOT, overrides=SMALL, seed=2**31 + 99):
    run = harness.Run(spec, cell, seed, 0.5, trace, "cpu", str(tmp_path), overrides, root=root)
    return run, harness.run_cell(run)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_rehearsal_is_correct(tmp_path, cell):
    run, out = _run(tmp_path, cell)
    assert list(out) == TOP + ["checks"]
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    e2e = {m["name"] for m in SPEC["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == e2e and "setup_s" in e2e
    assert run.checked_requests and run.checked_requests[-1] == run.records[-1][0]
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    json.dumps(out)


@pytest.mark.parametrize("cell", ["hp24-search-b128", "hp24-index-bacterial"])
def test_traced_rehearsal_reads_span_metrics(tmp_path, cell):
    run, out = _run(tmp_path, cell, trace=True)
    assert list(out) == TOP + ["breakdown", "checks"]
    assert out["correct"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    listed = {m["name"] for m in SPEC["per_layer"] if cell in m["workloads"]}
    # the CPU has no device trace: only the host-clock spans can be read
    assert set(out["metrics"]) == {n for n in listed if "_ms_per_" in n}
    assert all(v["value"] > 0 for v in out["metrics"].values())


def test_cell_added_as_new_files_only(tmp_path):
    """A configuration, a traffic mix and a metric added as files, and
    entries in BENCHMARK.json, are found by name; no file is edited."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "kbench"), root / "kbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(os.path.join(root, "kbench", p), "rb").read()
              for p in ("harness.py", "kinds/search_blocks.py", "gen.py")}
    spec = json.loads(json.dumps(SPEC))
    cfg = json.load(open(os.path.join(ROOT, "kbench/configs/hp-k24-s5-human.json")))
    cfg.update(name="dayhoff-k16-s5-test", moltype="dayhoff", ksize=16)
    (root / "kbench/configs/dayhoff-k16-s5-test.json").write_text(json.dumps(cfg))
    tr = json.load(open(os.path.join(ROOT, "kbench/traffic/query_blocks_b128.json")))
    tr["block"]["size"] = 4
    (root / "kbench/traffic/query_blocks_b4.json").write_text(json.dumps(tr))
    (root / "kbench/metrics/rows_per_block.search.py").write_text(
        "def read(run):\n    return float(len(run.records))\n")
    spec["configs"].append({"name": "dayhoff-k16-s5-test", "source": "a test",
                            "file": "kbench/configs/dayhoff-k16-s5-test.json", "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "d16-search-b4", "config": "dayhoff-k16-s5-test",
                              "traffic": "query_blocks_b4", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "hp24-search-b128" in m.get("workloads", []):
            m["workloads"].append("d16-search-b4")
    spec["per_layer"].append({"name": "rows_per_block.search", "unit": "1", "better": "lower",
                              "source": "host_clock", "layer": "a test", "moves": "search_queries_per_s",
                              "workloads": ["d16-search-b4"]})
    small = {"config": SMALL["config"], "traffic": {"pool_blocks_per_s": 4, "check_every": 2}}
    run, out = _run(tmp_path, "d16-search-b4", trace=True, spec=spec, root=str(root), overrides=small)
    assert out["correct"]
    assert out["metrics"]["rows_per_block.search"]["value"] == len(run.records)
    assert "join_ms_per_block.search" in out["metrics"]
    assert run.config["moltype"] == "dayhoff" and run.traffic["block"]["size"] == 4
    for p, data in before.items():
        assert open(os.path.join(root, "kbench", p), "rb").read() == data


@pytest.mark.parametrize("name,file", [("device_idle_pct.search", "device_idle_pct.py"),
                                       ("masked_sketch_roofline_pct.index", "masked_sketch_roofline_pct.py"),
                                       ("csv_ms_per_block.search", "csv_ms_per_block.search.py")])
def test_metric_reader_by_name_then_stem(name, file):
    """A metric's own file, or else the reader of its stem."""
    mod = harness.metric_reader(harness.ROOT, name)
    assert mod.__spec__.origin == os.path.join(harness.ROOT, "kbench", "metrics", file)
