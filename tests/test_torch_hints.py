"""The learned hints (``ops.sparse_search.export_learned_hints`` /
``seed_learned_hints``, ``ops.inverted`` dense block) against the JAX
package's: the same call sequence learns the same dict, keys included;
a ``.ksx`` saved by either package seeds the other's caches to the same
dict, in formats 2 and 1; a malformed ``hints.json`` is ignored; the
dense block is learned, persisted and used by ``inverted_search``."""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dense_engine import _corpus

import kmerseek_tpu.ops.sparse_search as jsp
from kmerseek_tpu.core.index import IndexConfig as JCfg
from kmerseek_tpu.core.index import ProteomeIndex as JIdx
from kmerseek_tpu.ops import inverted as jinv
from kmerseek_tpu.ops.u64 import split_np
from kmerseek_tpu_torch.core.index import IndexConfig, ProteomeIndex
from kmerseek_tpu_torch.ops import inverted as tinv
from kmerseek_tpu_torch.ops import sparse_search as tsp
from kmerseek_tpu_torch.ops.u64 import u64_np_to_tensor

CFG = (16, 5, "hp")
EMPTY = {"expand": {}, "hp": {}}


@pytest.fixture(autouse=True)
def _fresh_caches():
    for mod in (tsp, jsp):
        mod._EXPAND_CACHE.clear()
        mod._HP_CACHE.clear()
    tinv._DENSE_BLOCK_CACHE.clear()
    jinv._DENSE_BLOCK_CACHE.clear()
    yield


def _pair(seed=41, **kw):
    mins, ab, offsets, q64, qv = _corpus(seed=seed, **kw)
    names = [f"t{i}" for i in range(len(offsets) - 1)]
    port = ProteomeIndex.from_arrays(IndexConfig(*CFG), names, mins, ab, offsets, device="cpu")
    return port, JIdx(JCfg(*CFG), names, mins, ab, offsets), q64, qv


def _tq(q64, qv):
    return u64_np_to_tensor(q64), torch.from_numpy(qv)


def _jq(q64, qv):
    hi, lo = split_np(q64)
    return jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(qv)


def _sequence(port, ref, q64, qv):
    """The same calls in both packages: single blocks (auto and explicit
    capacity, two shapes), a chunked block (C_pad = 4), run-offset tiles
    and a stream; a repeat of the first call reads the learned hints."""
    calls = [
        ({}, q64, qv),
        ({"capacity": 300}, q64, qv),
        ({}, q64[:17], qv[:17]),
        ({"q_chunk": 12}, q64, qv),
        ({"run_chunk": 2}, q64, qv),
        ({}, q64, qv),
    ]
    for kw, a, b in calls:
        got = tsp.sparse_search(port, *_tq(a, b), **kw)
        want = jsp.sparse_search(ref, *_jq(a, b), **kw)
        assert got.n_hits == want.n_hits and np.array_equal(got.weight, np.asarray(want.weight))
    blocks = [(q64[:10], qv[:10]), (q64[10:20], qv[10:20])]
    for g, w in zip(
        tsp.sparse_search_stream(port, (_tq(a, b) for a, b in blocks)),
        jsp.sparse_search_stream(ref, (_jq(a, b) for a, b in blocks)),
    ):
        assert g.n_hits == w.n_hits and np.array_equal(g.t, np.asarray(w.t))


def test_same_calls_learn_the_same_hints():
    port, ref, q64, qv = _pair()
    assert tsp.export_learned_hints(port.inverted) == EMPTY == jsp.export_learned_hints(ref.inverted)
    _sequence(port, ref, q64, qv)
    got = tsp.export_learned_hints(port.inverted)
    assert got == jsp.export_learned_hints(ref.inverted)
    Q, S = q64.shape
    assert {f"{Q},{S}", f"17,{S}", f"12,{S}"} <= set(got["expand"])
    # (Q, S, run_offset, cap) keys and the chunked (C_pad, Qc, S, run_offset, cap) key
    assert f"{Q},{S},0,384" in got["hp"] and any(k.startswith(f"4,12,{S},0,") for k in got["hp"])
    assert any(k.startswith(f"{Q},{S},2,") for k in got["hp"])  # the second run tile


def _to_format1(src, dst):
    """A format-2 ``.ksx`` rewritten as format 1 (hints.json kept)."""
    shutil.copytree(src, dst)
    with open(os.path.join(src, "manifest.json")) as f:
        manifest = json.load(f)
    m = {n: np.load(os.path.join(src, f"{n}.npy")) for n in manifest["files"]}
    np.savez(os.path.join(dst, "arrays.npz"), mins=m["mins"], abundances=m["abundances"], offsets=m["offsets"])
    np.savez(
        os.path.join(dst, "inverted.npz"), g_hi=m["inv_g_hi"], g_lo=m["inv_g_lo"], tid=m["inv_tid"],
        ab=m["inv_ab"], bucket_starts=m["inv_bucket_starts"],
        shape=np.asarray(manifest["inverted_shape"], np.int64),
    )
    for name in os.listdir(dst):
        if name.endswith(".npy") or name == "manifest.json":
            os.remove(os.path.join(dst, name))
    with open(os.path.join(dst, "metadata.json")) as f:
        meta = json.load(f)
    with open(os.path.join(dst, "metadata.json"), "w") as f:
        json.dump(dict(meta, format_version=1), f)


@pytest.mark.parametrize("fmt", [2, 1])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_saved_hints_seed_the_other_package(tmp_path, writer, fmt):
    port, ref, q64, qv = _pair(seed=42)
    _sequence(port, ref, q64, qv)
    tinv.note_dense_block(port.inverted, 96)
    jinv.note_dense_block(ref.inverted, 96)
    learned = tsp.export_learned_hints(port.inverted)
    assert learned == jsp.export_learned_hints(ref.inverted) and learned["dense_block"] == 96
    path = str(tmp_path / "t.ksx")
    (port if writer == "port" else ref).save(path)
    with open(os.path.join(path, "hints.json")) as f:
        assert json.load(f) == learned
    if fmt == 1:
        _to_format1(path, str(tmp_path / "f1.ksx"))
        path = str(tmp_path / "f1.ksx")
    for mod in (tsp, jsp):
        mod._EXPAND_CACHE.clear()
        mod._HP_CACHE.clear()
    tinv._DENSE_BLOCK_CACHE.clear()
    jinv._DENSE_BLOCK_CACHE.clear()
    tl = ProteomeIndex.load(path, device="cpu")
    jl = JIdx.load(path)
    assert tsp.export_learned_hints(tl.inverted) == learned == jsp.export_learned_hints(jl.inverted)
    assert tinv.dense_block_hint(tl.inverted) == 96
    # a port re-save keeps them (a JAX-made .ksx no longer loses its hints)
    resaved = str(tmp_path / "re.ksx")
    tl.save(resaved)
    with open(os.path.join(resaved, "hints.json")) as f:
        assert json.load(f) == learned


def test_never_searched_index_writes_empty_hints(tmp_path):
    port, ref, _q, _v = _pair(seed=43)
    for name, idx in (("p", port), ("j", ref)):
        path = str(tmp_path / f"{name}.ksx")
        idx.save(path)
        with open(os.path.join(path, "hints.json")) as f:
            assert json.load(f) == EMPTY


@pytest.mark.parametrize(
    "bad",
    [
        "[1, 2]",
        "not json",
        '{"expand": [1], "hp": "x"}',
        '{"expand": {"a,b": 3, "1,2": [1], "5,6": 640}, "hp": {"x": 1, "1,2,0,128": {}, "3,4,0,256": 128},'
        ' "dense_block": "big"}',
        '{"dense_block": -3, "expand": {"1,2,3": 5}}',
    ],
)
def test_malformed_hints_are_ignored(tmp_path, bad):
    port, ref, q64, qv = _pair(seed=44)
    path = str(tmp_path / "t.ksx")
    port.save(path)
    with open(os.path.join(path, "hints.json"), "w") as f:
        f.write(bad)
    tl = ProteomeIndex.load(path, device="cpu")
    jl = JIdx.load(path)
    got = tsp.export_learned_hints(tl.inverted)
    assert got == jsp.export_learned_hints(jl.inverted)
    assert "dense_block" not in got and tinv.dense_block_hint(tl.inverted) == tinv.DEFAULT_DENSE_BLOCK
    if "5,6" in bad:  # the well-formed entries survive beside the bad ones
        assert got == {"expand": {"5,6": 640}, "hp": {"3,4,0,256": 128}}
    # the index still searches
    hits = tsp.sparse_search(tl, *_tq(q64, qv))
    assert hits.n_hits == jsp.sparse_search(jl, *_jq(q64, qv)).n_hits > 0


def test_dense_block_round_trip_and_r3(tmp_path, monkeypatch):
    """``inverted_search`` without ``q_block`` dispatches in the learned
    block (R3), a saved ``.ksx`` carries it, and the matrices equal the
    JAX function's under the same hint."""
    port, ref, q64, qv = _pair(seed=45, Q=40)
    tinv.note_dense_block(port.inverted, 16)
    jinv.note_dense_block(ref.inverted, 16)
    calls = []
    orig = tinv.inverted_pair_stats
    monkeypatch.setattr(tinv, "inverted_pair_stats", lambda dp, qk, *a, **k: calls.append(qk.shape[0]) or orig(dp, qk, *a, **k))
    c, w = tinv.inverted_search(port, *_tq(q64, qv))
    assert calls == [16, 16, 8]
    hi, lo = split_np(q64)
    jc, jw = jinv.inverted_search(ref, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(qv))
    assert np.array_equal(c.numpy(), np.asarray(jc)) and np.array_equal(w.numpy(), np.asarray(jw))
    calls.clear()
    tinv.inverted_search(port, *_tq(q64, qv), q_block=32)
    assert calls == [32, 8]
    path = str(tmp_path / "t.ksx")
    port.save(path)
    tinv._DENSE_BLOCK_CACHE.clear()
    loaded = ProteomeIndex.load(path, device="cpu")
    assert tinv.dense_block_hint(loaded.inverted) == 16
    assert tinv.dense_block_hint(port.inverted) == tinv.DEFAULT_DENSE_BLOCK  # another owner


def test_autotune_dense_block_records_winner():
    port, ref, _q, _v = _pair(seed=46)
    res = tinv.autotune_dense_block(port, sketch_slots=16, candidates=(8, 24), iters=2, device="cpu")
    assert sorted(res) == [8, 24]
    assert all(set(v) == {"queries_per_second", "compile_s"} and v["queries_per_second"] > 0 for v in res.values())
    best = max(res, key=lambda b: res[b]["queries_per_second"])
    assert tinv.dense_block_hint(port.inverted) == best
    assert tsp.export_learned_hints(port.inverted)["dense_block"] == best
    # the probe block is the JAX function's seeded draw: the same winner
    # bookkeeping, on the same candidates
    jres = jinv.autotune_dense_block(ref, sketch_slots=16, candidates=(8, 24), iters=2)
    assert sorted(jres) == [8, 24] and jinv.dense_block_hint(ref.inverted) in (8, 24)
    empty = ProteomeIndex.from_arrays(
        IndexConfig(*CFG), ["a"], np.zeros(0, np.uint64), np.zeros(0, np.int64), np.zeros(2, np.int64),
        device="cpu",
    )
    assert tinv.autotune_dense_block(empty, device="cpu") == {}
