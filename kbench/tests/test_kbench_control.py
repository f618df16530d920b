"""What decides ``correct`` has to fail: the precision control and each
fault a cell can have, planted in the timed path under a whole run."""

from unittest import mock

import pytest
from conftest import CELLS, SMALL, spec
from test_kbench_cells import _run

from kbench import control, harness


@pytest.mark.parametrize("cell", CELLS)
def test_precision_control_is_not_correct(tmp_path, cell):
    run = harness.Run(spec(), cell, 3, 0.5, False,
                      "cpu", str(tmp_path), SMALL)
    with control.patched(run):
        out = harness.run_cell(run)
    assert not out["correct"]
    assert out["failed"] == 0  # the control ran; its answers were judged wrong


def _search_faults():
    from kmerseek_tpu_torch.core import search

    orig = search.manysearch

    def half(query, target, threshold=0.0):
        keep = set(query.names[: len(query.names) // 2])
        return [r for r in orig(query, target, threshold) if r["query_name"] in keep]

    def altered(query, target, threshold=0.0):
        rows = orig(query, target, threshold)
        rows[len(rows) // 2]["intersect_hashes"] += 1
        return rows

    return {
        "unchanged": mock.patch.object(search, "write_search_csv", lambda *a, **k: None),
        "half": mock.patch.object(search, "manysearch", half),
        "altered": mock.patch.object(search, "manysearch", altered),
    }


def _index_faults():
    import numpy as np

    from kmerseek_tpu_torch.core.index import ProteomeIndex

    build = ProteomeIndex.build.__func__

    def half(cls, fasta, config=None, **kw):
        idx = build(cls, fasta, config, **kw)
        return cls.from_signatures(idx.signatures()[: len(idx) // 2], idx.config,
                                   source_fasta=idx.source_fasta, device=idx.device)

    def altered(cls, fasta, config=None, **kw):
        idx = build(cls, fasta, config, **kw)
        idx.mins = idx.mins.copy()
        idx.mins[len(idx.mins) // 2] ^= np.uint64(1)
        return idx

    return {
        "unchanged": mock.patch.object(ProteomeIndex, "save", lambda self, path: path),
        "half": mock.patch.object(ProteomeIndex, "build", classmethod(half)),
        "altered": mock.patch.object(ProteomeIndex, "build", classmethod(altered)),
    }


# one chip: no cell has an exchange between chips to leave out
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_in_the_timed_path_is_not_correct(tmp_path, cell, fault):
    faults = _search_faults() if "search" in cell else _index_faults()
    run = None
    with faults[fault]:
        run, out = _run(tmp_path, cell)
    assert not out["correct"], out["checks"]
