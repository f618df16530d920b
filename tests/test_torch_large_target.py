"""The search of a UniProtKB/Swiss-Prot-shaped target on the port's normal
path (``ProteomeIndex.build`` / ``save`` / ``load``, then ``manysearch``
and ``write_search_csv`` per block), held to the benchmark's plain
reference (``kbench/reference``) at a few thousand proteins; the
reference's chunked target sketch held to its one-pass sketch; and the
spans and counters that the large-target metrics read."""

import json
import os
from unittest import mock

import numpy as np
import pytest

from kbench import gen
from kbench.reference import products, search as ref_search, sketch, sketch_chunked
from kmerseek_tpu_torch import native
from kmerseek_tpu_torch.core.index import IndexConfig, ProteomeIndex
from kmerseek_tpu_torch.core.search import (
    MANYSEARCH_COLUMNS,
    _host_join,
    manysearch,
    write_search_csv,
)
from kmerseek_tpu_torch.core.signature import sourmash_md5, sourmash_md5s
from kmerseek_tpu_torch.utils import metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, SCALED, MOLTYPE = 24, 5, "hp"


def _swissprot_shape(proteins):
    with open(os.path.join(ROOT, "kbench", "configs", "hp-k24-s5-swissprot.json")) as f:
        shape = json.load(f)["target"]
    return dict(shape, proteins=proteins, giants=1, giant_min=3000, giant_max=4000)


def _block_spec():
    with open(os.path.join(ROOT, "kbench", "traffic", "query_blocks_b128_swissprot.json")) as f:
        return dict(json.load(f)["block"], size=32)


@pytest.fixture(scope="module")
def swissprot(tmp_path_factory):
    """A seeded 3,000-protein Swiss-Prot-shaped target through build,
    save and load, and two query blocks drawn from it."""
    d = tmp_path_factory.mktemp("swissprot")
    target = gen.proteome(_swissprot_shape(3000), gen.rng_for(2**31 + 21, 1), "target")
    fasta = gen.write_fasta(str(d / "target.fa"), target)
    blocks = []
    for b, block in enumerate(gen.query_blocks(target, _block_spec(), gen.rng_for(2**31 + 21, 2), 2)):
        blocks.append(gen.write_fasta(str(d / f"b{b}.fa"), block))
    cfg = IndexConfig(K, SCALED, MOLTYPE)
    ksx = str(d / "target.ksx")
    ProteomeIndex.build(fasta, cfg, device="cpu").save(ksx)
    return {"dir": d, "fasta": fasta, "blocks": blocks, "cfg": cfg,
            "target": ProteomeIndex.load(ksx, device="cpu")}


@pytest.mark.parametrize("block", [0, 1])
def test_swissprot_shaped_search_matches_the_reference(swissprot, block):
    path = swissprot["blocks"][block]
    query = ProteomeIndex.build(path, swissprot["cfg"], device="cpu")
    out = str(swissprot["dir"] / f"b{block}.csv")
    write_search_csv(manysearch(query, swissprot["target"]), MANYSEARCH_COLUMNS, out)
    t = sketch_chunked.sketch_fasta_chunked(swissprot["fasta"], K, SCALED, MOLTYPE, chunks=5, workers=1)
    ts = ref_search.TargetStats(t, sketch.postings(t), K)
    want = ref_search.manysearch(sketch.sketch_fasta(path, K, SCALED, MOLTYPE), ts, SCALED, MOLTYPE)
    assert len(want) > 20
    got = products.compare_csv(out, want)
    assert got["rows_off"] == 0 and got["exact_cells_off"] == 0
    assert got["float_rel_err"] <= 1e-9


def _corpus():
    """Proteins with empty sketches (shorter than k, or no kept window)
    among ordinary ones, so that chunk borders fall on them."""
    rng = np.random.default_rng(7)
    lens = [0, 5, 300, 23, 24, 150, 0, 900, 10, 60, 410, 2, 75, 30, 1]
    seqs = [gen.AA[rng.integers(0, 20, n)].tobytes() for n in lens]
    seqs[5] = seqs[5].lower() + b"*KQ"  # cleaned in the chunk: cased, cut after the stop
    return [f"p{i}" for i in range(len(seqs))], seqs


@pytest.mark.parametrize("chunks,workers", [(1, 1), (2, 1), (3, 1), (6, 1), (15, 1), (40, 1), (4, 2)])
def test_chunked_sketch_is_bit_equal_to_the_one_pass_sketch(chunks, workers):
    names, seqs = _corpus()
    k = 10  # short enough that several proteins keep no window and several do
    whole = sketch.sketch(names, [sketch.clean(s) for s in seqs], k, SCALED, MOLTYPE)
    got = sketch_chunked.sketch_chunked(names, seqs, k, SCALED, MOLTYPE, chunks=chunks, workers=workers)
    assert got.names == whole.names
    for a, b in zip(got[1:], whole[1:]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (np.diff(whole.offsets) == 0).sum() >= 4
    pa, pb = sketch.postings(got), sketch.postings(whole)
    for a, b in zip(pa, pb):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("chunks", [1, 4, 15, 100])
def test_chunk_bounds_are_contiguous_and_cover_every_protein(chunks):
    lens = np.array([len(s) for s in _corpus()[1]])
    b = sketch_chunked.chunk_bounds(lens, chunks)
    assert b[0] == 0 and b[-1] == len(lens) and all(x < y for x, y in zip(b, b[1:]))
    assert len(b) - 1 <= chunks
    if chunks >= len(lens):
        assert b == list(range(len(lens) + 1))  # one protein a chunk


def test_search_tuples_counts_the_host_join(swissprot):
    query = ProteomeIndex.build(swissprot["blocks"][0], swissprot["cfg"], device="cpu")
    with metrics.span("test.join") as sp:
        js = _host_join(query, swissprot["target"], inner="ab")
    recs = [r for r in metrics.records(since=sp.t0) if r.name == "search.join"]
    assert len(recs) == 1 and recs[0].counts["search.tuples"] == js.total == int(js.seg_n.sum()) > 0


def test_index_metadata_and_postings_loaded_once_per_save_and_load(swissprot, tmp_path):
    idx = swissprot["target"]
    with metrics.span("test.save") as sp:
        idx.save(str(tmp_path / "again.ksx"))
        ProteomeIndex.load(str(tmp_path / "again.ksx"), device="cpu")
    recs = metrics.records(since=sp.t0)
    by_id = {r.span_id: r for r in recs}
    meta = [by_id[r.parent_id].name for r in recs if r.name == "index.metadata"]
    assert sorted(meta) == ["index.load", "index.members"]
    loaded = [r.counts["index.postings_loaded"] for r in recs
              if r.counts and "index.postings_loaded" in r.counts]
    assert loaded == [len(idx.mins)] == [idx.inverted.n_postings]


@pytest.mark.parametrize("library", [True, False])
def test_bulk_md5s_equal_one_md5_a_signature(library):
    """Across the 1M-min pieces, with a signature longer than a piece, empty
    signatures and the extreme values, with and without the native
    library."""
    rng = np.random.default_rng(3)
    sizes = np.concatenate([rng.integers(0, 200, 3000), [0, (1 << 20) + 5, 0], rng.integers(0, 200, 500)])
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    mins = rng.integers(0, 2**64, offsets[-1], dtype=np.uint64)
    mins[:4] = [0, 9, 10, 2**64 - 1]
    want = [sourmash_md5(mins[a:b], K) for a, b in zip(offsets[:-1], offsets[1:])]
    if library:
        assert native.available()
        got = sourmash_md5s(mins, offsets, K)
    else:
        with mock.patch.object(native, "available", lambda: False):
            got = sourmash_md5s(mins, offsets, K)
    assert got == want
