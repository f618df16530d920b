"""A CPU rehearsal of the stitched search cell, small: the requests, the
spans, the check and the result line; the precision control
(``kbench/control_stitch.py``) and faults planted in the timed path
read not correct."""

import json
from unittest import mock

import pytest
from conftest import SMALL, spec
from test_kbench_cells import TOP, _run

from kbench import control_stitch, harness

CELL = "dayhoff24-search-extract-b128"
SPEC = spec()


def test_stitch_cell_rehearsal_is_correct(tmp_path):
    run, out = _run(tmp_path, CELL)
    assert list(out) == TOP + ["checks"]
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    # the p95 of ~30 blocks a window swings too far to hold (PERF.md section 2)
    assert set(out["metrics"]) == {"search_queries_per_s", "setup_s"}
    assert set(out["checks"]) == {"kmers_rows_off", "kmers_cells_off", "stitched_rows_off",
                                  "stitched_cells_off", "report_off"}
    assert run.checked_requests and run.checked_requests[-1] == run.records[-1][0]
    json.dumps(out)


def test_stitch_cell_traced_rehearsal_reads_the_new_metrics(tmp_path):
    run, out = _run(tmp_path, CELL, trace=True)
    assert out["correct"]
    listed = {m["name"] for m in SPEC["per_layer"] if CELL in m["workloads"]}
    # the CPU has no device trace: only the host-clock spans can be read
    assert set(out["metrics"]) == {n for n in listed if "_ms_per_" in n}
    new = {"kmers_ms_per_block.search", "stitch_ms_per_block.search", "stitch_scan_ms_per_mrow.search",
           "stitch_assemble_ms_per_block.search", "target_kmers_ms_per_mres.search"}
    assert new <= set(out["metrics"])
    assert all(v["value"] > 0 for v in out["metrics"].values())


def test_stitch_precision_control_is_not_correct(tmp_path):
    run = harness.Run(SPEC, CELL, 3, 0.5, False, "cpu", str(tmp_path), SMALL)
    with control_stitch.patched(run):
        out = harness.run_cell(run)
    assert not out["correct"] and out["failed"] == 0
    assert out["checks"]["kmers_cells_off"]["value"] > 0


def _faults():
    from kmerseek_tpu_torch.core import kmers, stitch

    write, sidecar = stitch.write_stitched, kmers.write_kmer_table_for_index

    def no_report(rows, q, t, out, report_out, **kw):
        return write(rows, q, t, out, out + ".elsewhere", **kw)

    def half_sidecar(index, path, sequence_file=None):
        import pyarrow.parquet as pq

        sidecar(index, path, sequence_file)
        table = pq.read_table(path)
        pq.write_table(table.slice(0, len(table) // 2), path)
        return path

    return {
        "nothing": mock.patch.object(stitch, "write_stitched", lambda *a, **k: None),
        "report": mock.patch.object(stitch, "write_stitched", no_report),
        "sidecar": mock.patch.object(kmers, "write_kmer_table_for_index", half_sidecar),
    }


@pytest.mark.parametrize("fault", ["nothing", "report", "sidecar"])
def test_stitch_fault_in_the_timed_path_is_not_correct(tmp_path, fault):
    with _faults()[fault]:
        run, out = _run(tmp_path, CELL)
    assert not out["correct"], out["checks"]
