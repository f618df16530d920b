"""The dense engine's remaining surface in the port (``ops.inverted``):
``build_inverted_dev`` / ``DeviceInvertedIndex`` against the host build
and the JAX ``build_inverted_dev``, every engine on a device-built index,
the ``KMERSEEK_INVERTED_BUILD`` dispatch, the ``.ksx`` round trip,
``packed``, ``max_abundance``, and ``inverted_pair_stats_packed`` /
``_bucketed`` against the JAX functions, bucketed and full-range. Seeded
numpy inputs; tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dense_engine import _corpus

import kmerseek_tpu.core.search as jsearch
import kmerseek_tpu.ops.sparse_search as jsp
from kmerseek_tpu.core.index import IndexConfig as JCfg
from kmerseek_tpu.core.index import ProteomeIndex as JIdx
from kmerseek_tpu.ops import inverted as jinv
from kmerseek_tpu.ops.u64 import split_np
from kmerseek_tpu_torch.core import search as tsearch
from kmerseek_tpu_torch.core.index import IndexConfig, ProteomeIndex
from kmerseek_tpu_torch.ops import inverted as tinv
from kmerseek_tpu_torch.ops import sparse_search as tsp
from kmerseek_tpu_torch.ops.u64 import u64_np_to_tensor
from kmerseek_tpu_torch.parallel import dist as tdist

CFG = (16, 5, "hp")
FIELDS = ("g_hi", "g_lo", "tid", "ab", "bucket_starts")
SCALARS = ("n_targets", "max_run", "max_span", "bucket_shift")


def _same_inv(a, b):
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert [int(getattr(a, f)) for f in SCALARS] == [int(getattr(b, f)) for f in SCALARS]


def _case(name):
    """(mins, ab, offsets): the shared corpus, equal hashes in many
    targets (stable tid order), and extreme hashes."""
    if name == "default":
        return _corpus(seed=51)[:3]
    if name == "runs":  # one hash in every target, plus ties everywhere
        rng = np.random.default_rng(52)
        T = 60
        rows = [np.unique(np.append(rng.integers(0, 50, size=8, dtype=np.uint64) * np.uint64(2**40), 7)) for _ in range(T)]
        mins = np.concatenate(rows)
        offsets = np.concatenate([[0], np.cumsum([len(r) for r in rows])]).astype(np.int64)
        return mins, rng.integers(1, 9, size=len(mins)).astype(np.int64), offsets
    M = 0xFFFFFFFFFFFFFFFF  # "extreme": 0, u64::MAX, both sides of 2^63
    rows = [np.array([0, 5, 2**63 - 1], np.uint64), np.array([2**63, M], np.uint64), np.array([0, 2**63, M], np.uint64)]
    mins = np.concatenate(rows)
    offsets = np.array([0, 3, 5, 8], np.int64)
    return mins, np.array([1, 2, 3, 2**31 - 1, 5, 6, 7, 8], np.int64), offsets


@pytest.mark.parametrize("name", ["default", "runs", "extreme"])
def test_build_inverted_dev_matches_host_and_jax(name):
    mins, ab, offsets = _case(name)
    dev = tinv.build_inverted_dev(mins, ab, offsets, "cpu")
    assert isinstance(dev, tinv.DeviceInvertedIndex) and dev._host_cols is None
    assert dev.n_postings == len(mins) and dev.g4_dev.dtype == torch.int32 and dev.g4_dev.shape == (len(mins), 4)
    host = tinv.build_inverted_np(mins, ab, offsets)
    assert dev.max_ab == tinv.max_abundance(host) == int(ab.max())
    assert tinv.max_abundance(dev) == jinv.max_abundance(jinv.build_inverted_np(mins, ab, offsets))
    # the host columns come down once, as stable objects
    g_hi = dev.g_hi
    assert dev.g_hi is g_hi and dev.tid is dev.tid and dev.bucket_starts is dev.bucket_starts
    _same_inv(dev, host)
    jdev = jinv.build_inverted_dev(mins, ab, offsets)
    _same_inv(dev, jdev)
    assert np.array_equal(dev.packed(), np.asarray(jdev.g4_dev))
    assert np.array_equal(dev.g4_dev.numpy().view(np.uint32), np.asarray(jdev.g4_dev))
    assert np.array_equal(host.packed(), jinv.build_inverted_np(mins, ab, offsets).packed())
    assert np.array_equal(dev.g64(), host.g64())
    _same_inv(dev.to_host(), host)
    if name == "runs":
        assert host.max_run == 60


def test_empty_index_builds_on_the_host():
    z = np.zeros(0, np.uint64)
    got = tinv.build_inverted_dev(z, z.astype(np.int64), np.zeros(4, np.int64), "cpu")
    assert isinstance(got, tinv.InvertedIndex) and got.n_postings == 0 and got.n_targets == 3


def test_device_postings_passthrough_and_clear():
    mins, ab, offsets = _case("default")
    dev = tinv.build_inverted_dev(mins, ab, offsets, "cpu")
    tinv.clear_device_postings()
    assert tinv.device_postings(dev, "cpu") is dev.dp
    assert not tinv._DEVICE_CACHE and dev._host_cols is None  # no upload, no download
    tinv.clear_device_postings(dev)
    assert tinv.device_postings(dev, "cpu") is dev.dp
    assert tsp._cache_owner(dev) is dev.g4_dev and dev._host_cols is None


def _pair_with(inverted):
    mins, ab, offsets, q64, qv = _corpus(seed=53)
    names = [f"t{i}" for i in range(len(offsets) - 1)]
    port = ProteomeIndex.from_arrays(IndexConfig(*CFG), names, mins, ab, offsets, device="cpu")
    if inverted == "device":
        port._inverted = tinv.build_inverted_dev(mins, ab, offsets, "cpu")
    ref = JIdx(JCfg(*CFG), names, mins, ab, offsets)
    return port, ref, q64, qv


def _tq(q64, qv):
    return u64_np_to_tensor(q64), torch.from_numpy(qv)


def _jq(q64, qv):
    hi, lo = split_np(q64)
    return jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(qv)


def test_every_engine_accepts_a_device_index():
    port, ref, q64, qv = _pair_with("device")
    dinv = port.inverted
    assert isinstance(dinv, tinv.DeviceInvertedIndex)
    # the dense engine and the sparse engine read the device postings
    c, w = tinv.inverted_search(port, *_tq(q64, qv))
    jc, jw = jinv.inverted_search(ref, *_jq(q64, qv))
    assert np.array_equal(c.numpy(), np.asarray(jc)) and np.array_equal(w.numpy(), np.asarray(jw))
    hits = tsp.sparse_search(port, *_tq(q64, qv), q_chunk=16)
    want = jsp.sparse_search(ref, *_jq(q64, qv), q_chunk=16)
    for f in ("q", "t", "count", "weight"):
        assert np.array_equal(getattr(hits, f), np.asarray(getattr(want, f))), f
    (streamed,) = tsp.sparse_search_stream(port, [_tq(q64, qv)])
    assert np.array_equal(streamed.t, hits.t)
    assert tsp.warm_sparse_engine(port, q64.shape)
    assert dinv._host_cols is None  # none of these downloaded the postings
    # the host join, the host route and the sharded engines take the host columns
    host = tsp.sparse_search_host(port, *_tq(q64, qv))
    assert np.array_equal(host.weight, hits.weight)
    mesh = tdist.make_mesh(3, device="cpu")
    sc, sw = tdist.sharded_inverted_search(mesh, dinv, *_tq(q64, qv))
    assert torch.equal(sc, c) and torch.equal(sw, w)
    sh = tdist.sharded_sparse_search(mesh, dinv, *_tq(q64, qv))
    assert np.array_equal(sh.count, hits.count) and np.array_equal(sh.weight, hits.weight)
    tdist.clear_sharded_sparse_cache(dinv)
    q = ProteomeIndex.from_arrays(
        IndexConfig(*CFG), [f"q{i}" for i in range(len(q64))], q64[qv], np.ones(int(qv.sum()), np.int64),
        np.concatenate([[0], np.cumsum(qv.sum(axis=1))]).astype(np.int64), device="cpu",
    )
    jq = JIdx(JCfg(*CFG), q.names, q.mins, q.abundances, q.offsets)
    assert tsearch.manysearch(q, port) == jsearch.manysearch(jq, ref)


@pytest.mark.parametrize("mode", ["auto", "host", "device", "unknown"])
def test_inverted_build_dispatch(monkeypatch, mode):
    """R2: ``KMERSEEK_INVERTED_BUILD`` picks the build; every build gives
    the same postings."""
    mins, ab, offsets = _case("default")
    monkeypatch.setenv("KMERSEEK_INVERTED_BUILD", mode)
    tinv.clear_device_postings()
    port = ProteomeIndex.from_arrays(IndexConfig(*CFG), [f"t{i}" for i in range(len(offsets) - 1)], mins, ab, offsets, device="cpu")
    inv = port.inverted
    if mode == "device":
        assert isinstance(inv, tinv.DeviceInvertedIndex)
    else:
        assert isinstance(inv, tinv.InvertedIndex)
        # auto (and an unknown value) caches the device sort; host uploads nothing
        assert bool(tinv._DEVICE_CACHE) == (mode != "host")
    _same_inv(inv, tinv.build_inverted_np(mins, ab, offsets))


def test_ksx_round_trip_from_a_device_index(tmp_path, monkeypatch):
    """``save`` of a device-built index makes its host columns from the
    CSR arrays (no download) and writes the members of a host-built
    index's save; the load gives them back."""
    import json

    port, ref, q64, qv = _pair_with("device")
    dinv = port.inverted
    monkeypatch.setattr(tinv.DeviceInvertedIndex, "_host", lambda self: self._host_cols or pytest.fail("downloaded"))
    a = str(tmp_path / "dev.ksx")
    port.save(a)
    assert dinv._host_cols is not None
    monkeypatch.undo()
    host_idx, _r, _q, _v = _pair_with("host")
    b = str(tmp_path / "host.ksx")
    host_idx.save(b)
    for name in ("inv_g_hi", "inv_g_lo", "inv_tid", "inv_ab", "inv_bucket_starts", "mins", "abundances", "offsets"):
        x, y = np.load(f"{a}/{name}.npy"), np.load(f"{b}/{name}.npy")
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    with open(f"{a}/manifest.json") as f, open(f"{b}/manifest.json") as g:
        assert json.load(f)["inverted_shape"] == json.load(g)["inverted_shape"]
    _same_inv(ProteomeIndex.load(a, device="cpu").inverted, host_idx.inverted)
    _same_inv(JIdx.load(a).inverted, host_idx.inverted)
    # ensure_host_from_source is a no-op once the columns exist, or on a length mismatch
    assert not dinv.ensure_host_from_source(port.mins, port.abundances, port.offsets)
    fresh = tinv.build_inverted_dev(port.mins, port.abundances, port.offsets, "cpu")
    assert not fresh.ensure_host_from_source(port.mins[:-1], port.abundances[:-1], port.offsets)
    _same_inv(fresh, host_idx.inverted)  # downloaded


@pytest.mark.parametrize("bucketed", [True, False])
@pytest.mark.parametrize("name", ["default", "runs", "extreme"])
def test_pair_stats_packed_and_bucketed_match_jax(bucketed, name):
    mins, ab, offsets = _case(name)
    host = tinv.build_inverted_np(mins, ab, offsets)
    rng = np.random.default_rng(54)
    q64 = np.sort(np.concatenate([mins[rng.integers(0, len(mins), size=(9, 6))], rng.integers(0, 2**64 - 1, size=(9, 3), dtype=np.uint64)], axis=1), axis=1)
    qv = np.ones(q64.shape, bool)
    qv[:, 1:] = q64[:, 1:] != q64[:, :-1]
    qv[0, :2] = False
    N = host.n_postings
    steps = max(int(host.max_span if bucketed else N).bit_length(), 1)
    kw = dict(n_targets=host.n_targets, max_run=host.max_run, span_steps=steps, bucket_shift=host.bucket_shift)
    dev = tinv.build_inverted_dev(mins, ab, offsets, "cpu")
    starts = dev.bucket_starts_dev if bucketed else None
    got = tinv.inverted_pair_stats_packed(dev.g4_dev, starts, *_tq(q64, qv), **kw)
    jdev = jinv.build_inverted_dev(mins, ab, offsets)
    want = jinv.inverted_pair_stats_packed(jdev.g4_dev, jdev.bucket_starts_dev if bucketed else None, *_jq(q64, qv), **kw)
    split = tinv.inverted_pair_stats(tinv.device_postings(host, "cpu")._replace(
        bucket_starts=tinv.device_postings(host, "cpu").bucket_starts if bucketed else None), *_tq(q64, qv), **kw)
    for g, w, s in zip(got, want, split):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w)) and torch.equal(g, s)
    assert int(got[0].sum()) > 0
    if bucketed:
        cols = [torch.from_numpy(np.asarray(getattr(host, f)).astype(np.int64)) for f in FIELDS]
        bk = tinv.inverted_pair_stats_bucketed(*cols, *_tq(q64, qv), **kw)
        jbk = jinv.inverted_pair_stats_bucketed(
            *(jnp.asarray(getattr(host, f)) for f in FIELDS), *_jq(q64, qv), **kw
        )
        for g, w, s in zip(bk, jbk, got):
            assert np.array_equal(g.numpy(), np.asarray(w)) and torch.equal(g, s)
