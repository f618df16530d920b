"""The port's inverted build, sparse hit-list engine and manysearch CSV
against the JAX package's, on the seeded synthetic corpora of
``tests/_synth.py`` and a seeded FASTA. Bit-equal (tolerance 0)."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmerseek_tpu.ops.inverted import build_inverted_np as jax_build_np
from kmerseek_tpu.ops.sparse_search import sparse_search as jax_sparse
from kmerseek_tpu.ops.u64 import split_np
from kmerseek_tpu_torch.core.index import IndexConfig, ProteomeIndex
from kmerseek_tpu_torch.ops.inverted import build_inverted, build_inverted_np
from kmerseek_tpu_torch.ops.sparse_search import sparse_search
from kmerseek_tpu_torch.ops.u64 import u64_np_to_tensor
from _synth import synth_corpus
from test_torch_index import write_fasta
from test_torch_multisearch import cross_checks

INV_FIELDS = ("g_hi", "g_lo", "tid", "ab", "bucket_starts")


def _corpus(T=12000, S=24, Q=48, seed=3, high_ab=False):
    mins, ab, offsets, q64, qv = synth_corpus(T, S, Q, seed)
    if high_ab:  # summed weights beyond int32
        ab = np.random.default_rng(seed).integers(2**29, 2**31 - 1, size=len(ab))
    return mins, ab, offsets, q64, qv


def _assert_inv_equal(a, b):
    for f in INV_FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert (a.n_targets, a.max_run, a.max_span, a.bucket_shift) == (
        b.n_targets, b.max_run, b.max_span, b.bucket_shift,
    )


def test_inverted_builds_match_jax():
    mins, ab, offsets, _q, _v = _corpus()
    ref = jax_build_np(mins, ab, offsets)
    _assert_inv_equal(build_inverted_np(mins, ab, offsets), ref)
    dev = build_inverted(mins, ab, offsets, "cpu")
    _assert_inv_equal(dev, ref)
    assert ref.max_run > 1  # shared hashes: tie order is exercised


def test_inverted_unsigned_order_and_empty():
    """Hashes >= 2^63 (scaled=1) sort as unsigned; equal hashes stay
    target-ascending; an empty corpus builds."""
    mins = np.array([2**64 - 1, 2**63, 5, 2**63, 7, 5], np.uint64)
    ab = np.arange(1, 7)
    offsets = np.array([0, 2, 4, 6])
    _assert_inv_equal(build_inverted(mins, ab, offsets, "cpu"), jax_build_np(mins, ab, offsets))
    empty = build_inverted(np.zeros(0, np.uint64), np.zeros(0), np.array([0, 0]), "cpu")
    assert empty.n_postings == 0


def _index(mins, ab, offsets):
    T = len(offsets) - 1
    return ProteomeIndex.from_arrays(
        IndexConfig(16, 5, "hp"), [f"t{i}" for i in range(T)], mins, ab, offsets,
        device="cpu",
    )


@pytest.mark.parametrize(
    "kw,high_ab",
    [
        ({}, False),
        ({"q_chunk": 16}, False),
        ({"run_chunk": 2}, False),
        ({"q_chunk": 20, "run_chunk": 3}, False),
        ({"capacity": 100}, False),
        ({"capacity": 10, "run_chunk": 2}, False),
        ({}, True),
    ],
)
def test_sparse_search_matches_jax(kw, high_ab):
    from kmerseek_tpu.core.index import IndexConfig as JCfg
    from kmerseek_tpu.core.index import ProteomeIndex as JIdx

    mins, ab, offsets, q64, qv = _corpus(high_ab=high_ab)
    port = _index(mins, ab, offsets)
    ref = JIdx(JCfg(16, 5, "hp"), [f"t{i}" for i in range(len(offsets) - 1)], mins, ab, offsets)
    got = sparse_search(port, u64_np_to_tensor(q64), torch.from_numpy(qv), **kw)
    hi, lo = split_np(q64)
    exp = jax_sparse(ref, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(qv), **kw)
    assert got.n_hits == exp.n_hits > 0
    for f in ("q", "t", "count", "weight"):
        assert np.array_equal(getattr(got, f), np.asarray(getattr(exp, f))), f
    if "capacity" in kw:
        assert len(got.q) < got.n_hits
    if high_ab:
        assert got.weight.max() >= 2**31


def test_manysearch_csv_matches_jax(tmp_path):
    import kmerseek_tpu.core.search as jsearch
    from kmerseek_tpu.core.index import IndexConfig as JCfg
    from kmerseek_tpu.core.index import ProteomeIndex as JIdx
    from kmerseek_tpu_torch.core import search as tsearch

    tfa, qfa = str(tmp_path / "t.fa"), str(tmp_path / "q.fa")
    seqs = write_fasta(tfa, n=40, seed=5, max_len=400)
    rng = np.random.default_rng(6)
    with open(qfa, "w") as f:
        for i, s in enumerate(seqs[:12]):
            a = int(rng.integers(0, max(len(s) - 60, 1)))
            f.write(f">q{i}\n{s[a : a + 120].decode()}\n")
        f.write(">none\nMKVLAAGIVLLLAAGCSS\n")
    cfg = (16, 5, "hp")
    pq = ProteomeIndex.build(qfa, IndexConfig(*cfg), device="cpu")
    pt = ProteomeIndex.build(tfa, IndexConfig(*cfg), device="cpu")
    jq = JIdx.build(qfa, JCfg(*cfg), engine="device")
    jt = JIdx.build(tfa, JCfg(*cfg), engine="device")
    runs = cross_checks()
    out_p = tsearch.rows_to_csv(tsearch.manysearch(pq, pt), tsearch.MANYSEARCH_COLUMNS)
    assert cross_checks() == runs + 1
    out_j = io.StringIO()
    jsearch._write_rows(out_j, jsearch.manysearch(jq, jt), jsearch.MANYSEARCH_COLUMNS)
    assert out_p == out_j.getvalue()
    assert out_p.count("\n") > 12


def test_every_manysearch_call_is_cross_checked():
    """Three calls on one (query, target) pair run the device
    cross-check three times: there is no schedule that skips a call."""
    from kmerseek_tpu_torch.core import search as tsearch

    mins, ab, offsets, _q, _v = _corpus(T=600, Q=8)
    target = _index(mins, ab, offsets)
    query = _index(mins[: offsets[8]], ab[: offsets[8]], offsets[:9])
    runs = cross_checks()
    rows = [tsearch.manysearch(query, target) for _ in range(3)]
    assert cross_checks() == runs + 3
    assert len(rows[0]) >= 8 and rows[0] == rows[1] == rows[2]


# sketch sizes per target: 0 marks an empty sketch
SUM_LAYOUTS = {
    "empty_first": [0, 3, 5, 2],
    "empty_middle": [4, 0, 0, 3],
    "empty_last": [2, 6, 0],
    "empty_everywhere": [0, 1, 0, 7, 0, 0],
    "one_target": [5],
    "one_empty_target": [0],
}


@pytest.mark.parametrize("layout", list(SUM_LAYOUTS))
def test_target_sums_match_the_per_block_expression(layout):
    """``t_sizes`` / ``t_weight`` equal, bit for bit and in dtype, the
    ``np.append`` + ``reduceat`` expression the columns once ran every
    block, and a plain per-target sum; empty sketches read 0 wherever
    they lie."""
    sizes = np.asarray(SUM_LAYOUTS[layout], np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    rng = np.random.default_rng(len(sizes))
    mins = np.sort(rng.integers(1, 2**63, size=int(offsets[-1]), dtype=np.uint64))
    ab = rng.integers(1, 2**40, size=int(offsets[-1]))
    target = _index(mins, ab, offsets)
    former_sizes = np.diff(offsets)
    former_weight = np.add.reduceat(np.append(ab, 0), offsets[:-1]) * (former_sizes > 0)
    plain = np.array([ab[a:b].sum() for a, b in zip(offsets[:-1], offsets[1:])], np.int64)
    assert target.t_sizes.dtype == target.t_weight.dtype == np.int64
    assert np.array_equal(target.t_sizes, former_sizes)
    assert np.array_equal(target.t_weight, former_weight)
    assert np.array_equal(target.t_weight, plain)
    assert np.array_equal(target.t_weight[sizes == 0], np.zeros(int((sizes == 0).sum())))


def test_target_sums_built_once_per_target():
    """Two ``manysearch_columns`` calls against one target give the same
    columns, and the target's sums are built once across both
    (counter ``search.target_sums``)."""
    from kmerseek_tpu_torch.core import search as tsearch
    from kmerseek_tpu_torch.utils import metrics

    mins, ab, offsets, _q, _v = _corpus(T=600, Q=8)
    target = _index(mins, ab, offsets)
    query = _index(mins[: offsets[8]], ab[: offsets[8]], offsets[:9])
    built = metrics.counters().get("search.target_sums", 0)
    first = tsearch.manysearch_columns(query, target)
    second = tsearch.manysearch_columns(query, target)
    assert metrics.counters().get("search.target_sums", 0) == built + 1
    assert list(first) == list(second) and len(first["query_name"]) >= 8
    for k, v in first.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == second[k].dtype and np.array_equal(v, second[k]), k
        else:
            assert v == second[k], k
