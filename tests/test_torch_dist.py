"""The port's ``parallel.dist`` on ``make_mesh(8, device="cpu")`` against
the JAX package's ``parallel.dist`` on its eight virtual CPU devices, and
against the port's own single-device engines. Inputs are made from a seed
with numpy; everything is integer: tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmerseek_tpu.parallel.dist as jdist
from kmerseek_tpu.core.index import IndexConfig as JCfg
from kmerseek_tpu.core.index import ProteomeIndex as JIdx
from kmerseek_tpu.ops.u64 import join_np, split_np
from kmerseek_tpu_torch.core import search as tsearch
from kmerseek_tpu_torch.core.index import IndexConfig, ProteomeIndex
from kmerseek_tpu_torch.ops import inverted as tinv
from kmerseek_tpu_torch.ops import sparse_search as tsp
from kmerseek_tpu_torch.ops.u64 import u64_np_to_tensor
from kmerseek_tpu_torch.parallel import dist as tdist
from test_torch_dense_engine import _corpus

CFG = (16, 5, "hp")
N_SHARDS = 8


@pytest.fixture(scope="module")
def mesh():
    return tdist.make_mesh(N_SHARDS, device="cpu")


@pytest.fixture(scope="module")
def jmesh():
    m = jdist.make_mesh()
    assert m.devices.size == N_SHARDS
    return m


def _pair(mins, ab, offsets, prefix="t"):
    names = [f"{prefix}{i}" for i in range(len(offsets) - 1)]
    return (
        ProteomeIndex.from_arrays(IndexConfig(*CFG), names, mins, ab, offsets, device="cpu"),
        JIdx(JCfg(*CFG), names, mins, ab, offsets),
    )


def _query_pair(q64, qv):
    counts = qv.sum(axis=1)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    mins = q64[qv]
    return _pair(mins, (np.arange(len(mins)) % 5 + 1).astype(np.int64), offsets, "q")


def _case(name):
    """→ (mins, ab, offsets, q64, qv) of a named corpus."""
    if name == "top_bit":  # scaled = 1: hashes on both sides of 2^63
        return _corpus(seed=12, span=2**64 - 1)
    if name == "wrap":  # abundances near 2^31: a pair's int32 sum wraps
        return _corpus(seed=13, ab_lo=2**30, ab_hi=2**31 - 1)
    if name == "heavy":  # one hash in every target: a run longer than a slice
        mins, ab, offsets, q64, qv = _corpus(seed=14, T=199, S=7, pool_size=3000)
        common = np.uint64(mins[len(mins) // 2])
        rows = []
        for i in range(len(offsets) - 1):
            m, a = mins[offsets[i] : offsets[i + 1]], ab[offsets[i] : offsets[i + 1]]
            if common not in m:
                j = int(np.searchsorted(m, common))
                m, a = np.insert(m, j, common), np.insert(a, j, 3)
            rows.append((m, a))
        mins = np.concatenate([m for m, _a in rows])
        ab = np.concatenate([a for _m, a in rows])
        offsets = np.concatenate([[0], np.cumsum([len(m) for m, _a in rows])]).astype(np.int64)
        q64 = q64.copy()
        q64[0, 0] = common
        q64[0] = np.sort(q64[0])
        qv = np.ones_like(qv)
        qv[:, 1:] = q64[:, 1:] != q64[:, :-1]
        return mins, ab, offsets, q64, qv
    if name == "above_max":
        mins, ab, offsets, q64, qv = _corpus()
        q64, qv = q64.copy(), qv.copy()
        q64[:, -3:] = np.array([mins.max() + 1, 2**64 - 3, 2**64 - 2], np.uint64)
        qv[:, -3:] = True
        return mins, ab, offsets, q64, qv
    return _corpus()


def _q(q64, qv):
    return u64_np_to_tensor(q64), torch.from_numpy(qv)


def _jq(q64, qv):
    hi, lo = split_np(q64)
    return jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(qv)


def _same_hits(got, want):
    assert got.n_hits == want.n_hits
    for f in ("q", "t", "count", "weight"):
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert np.array_equal(a, b), f
    assert got.weight.dtype == np.int64 and got.q.dtype == np.int32


# ----------------------------------------------------------------------
# mesh, padding, target sharding
# ----------------------------------------------------------------------


def test_mesh_of_logical_cpu_shards():
    m = tdist.make_mesh(8, device="cpu")
    assert m.size == 8 and all(d == torch.device("cpu") for d in m.devices)
    assert tdist.make_mesh(device="cpu").size == 1
    with pytest.raises(Exception):
        m.devices = ()  # immutable
    if not torch.cuda.is_available():
        for call in (lambda: tdist.make_mesh(), lambda: tdist.make_mesh(4), lambda: tdist.make_mesh(2, "cuda:0")):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


@pytest.mark.parametrize("shape,mult,axis", [((5, 3), 8, 0), ((16, 3), 8, 0), ((4, 7), 4, 1), ((0, 2), 8, 0)])
def test_pad_to_multiple_matches_jax(shape, mult, axis):
    arr = np.arange(int(np.prod(shape)), dtype=np.int32).reshape(shape)
    got = tdist.pad_to_multiple(arr, mult, axis=axis, fill=7)
    assert np.array_equal(got, jdist.pad_to_multiple(arr, mult, axis=axis, fill=7))
    assert got.shape[axis] % mult == 0


def test_shard_targets_pads_with_empty_sketches(mesh, jmesh):
    mins, ab, offsets, _q64, _qv = _corpus(T=43)
    port, ref = _pair(mins, ab, offsets)
    keys, abund, counts = tdist.shard_targets(mesh, *port.dense_device_arrays())
    assert len(keys) == len(abund) == len(counts) == N_SHARDS
    assert all(k.shape[0] == 6 for k in keys)  # 43 rows → 48
    k_all, a_all, c_all = (torch.cat(x).numpy() for x in (keys, abund, counts))
    assert (k_all[43:] == -1).all() and (a_all[43:] == 0).all() and (c_all[43:] == 0).all()
    jhi, jlo, jab, jc = jdist.shard_targets(jmesh, *ref.dense_device_arrays())
    assert np.array_equal(k_all.view(np.uint64), join_np(np.asarray(jhi), np.asarray(jlo)))
    assert np.array_equal(a_all, np.asarray(jab)) and np.array_equal(c_all, np.asarray(jc))


# ----------------------------------------------------------------------
# target-sharded pair statistics and the pipeline step
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name", ["default", "wrap"])
def test_distributed_manysearch_stats_match_jax_and_single_device(mesh, jmesh, name):
    mins, ab, offsets, q64, qv = _case(name)
    mins, ab, offsets = mins[: offsets[43]], ab[: offsets[43]], offsets[:44]  # T = 43: not a multiple of 8
    port_t, ref_t = _pair(mins, ab, offsets)
    port_q, ref_q = _query_pair(q64, qv)
    got = tdist.distributed_manysearch_stats(port_q, port_t, mesh)
    want = jdist.distributed_manysearch_stats(ref_q, ref_t, jmesh)
    single = tsearch._device_pair_stats(port_q, port_t)
    for g, w, s in zip(got, want, single):
        assert g.shape == (len(q64), 43) and g.dtype == np.int32
        assert np.array_equal(g, w) and np.array_equal(g, s)
    assert got[0].max() >= 2
    if name == "wrap":
        assert (got[1][got[0] >= 2] < 0).any()  # a weighted sum wrapped, alike on all three


def test_sharded_pairwise_stats_blocks_concatenate(mesh):
    from kmerseek_tpu_torch.ops.intersect import pairwise_stats

    mins, ab, offsets, q64, qv = _corpus(T=48)
    port_t, _ = _pair(mins, ab, offsets)
    port_q, _ = _query_pair(q64, qv)
    qk, _qa, qc = port_q.dense_device_arrays()
    tk, ta, tc = port_t.dense_device_arrays()
    got = tdist.sharded_pairwise_stats(mesh, qk, qc, *tdist.shard_targets(mesh, tk, ta, tc))
    want = pairwise_stats(qk, qc, tk, ta, tc)
    assert torch.equal(got.intersect, want.intersect) and torch.equal(got.weighted, want.weighted)


def test_dist_pipeline_step_matches_jax(mesh, jmesh):
    """Full sharded step: data-parallel sketch + gather + sharded
    intersect. Row 0 is a repeated motif, so its sketch has heavy
    duplicates: the intersection must count distinct hashes only."""
    from kmerseek_tpu_torch.ops.intersect import pairwise_stats
    from kmerseek_tpu_torch.ops.sketch import sketch_batch

    rng = np.random.default_rng(0)
    letters = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
    B, L, T = N_SHARDS * 2, 256, 21
    seqs = letters[rng.integers(0, 20, size=(B, L))]
    seqs[0] = np.tile(seqs[0, :32], L // 32)
    lens = np.full(B, L, np.int32)
    lens[3] = 100
    # targets: the query rows themselves plus unrelated ones, T not a multiple of 8
    t_seqs = np.concatenate([seqs[:13], letters[rng.integers(0, 20, size=(T - 13, L))]])
    kw = dict(k=16, scaled=5, moltype="hp", capacity=128)
    tb = sketch_batch(torch.from_numpy(t_seqs), torch.full((T,), L, dtype=torch.int32), **kw)

    step = tdist.make_dist_pipeline_step(mesh, **kw)
    out = step(seqs, lens, *tdist.shard_targets(mesh, tb.mins, tb.abund, tb.counts))
    assert out.intersect.shape == (B, 24) and out.intersect.dtype == torch.int32

    hi, lo = split_np(tb.mins.numpy().view(np.uint64))
    jt = jdist.shard_targets(jmesh, hi, lo, tb.abund.numpy(), tb.counts.numpy())
    jstep = jdist.make_dist_pipeline_step(jmesh, **kw)
    ji, jw, jtotal = jstep(jnp.asarray(seqs), jnp.asarray(lens), *jt)
    assert np.array_equal(out.intersect.numpy(), np.asarray(ji))
    assert np.array_equal(out.weighted.numpy(), np.asarray(jw))
    assert int(out.total_retained) == int(jtotal) > 0

    # and the single-device route: dense sketches through pairwise_stats
    sk = sketch_batch(torch.from_numpy(seqs), torch.from_numpy(lens), **kw)
    ref = pairwise_stats(sk.mins, sk.counts, tb.mins, tb.abund, tb.counts)
    assert torch.equal(out.intersect[:, :T], ref.intersect)
    assert torch.equal(out.weighted[:, :T], ref.weighted)
    assert int(out.total_retained) == int(sk.counts.sum())
    assert (out.intersect[:, T:] == 0).all()
    assert int(out.intersect[0, 0]) == int(sk.counts[0]) < 20  # the motif row against itself
    with pytest.raises(ValueError, match="do not split"):
        step(seqs[:5], lens[:5], *tdist.shard_targets(mesh, tb.mins, tb.abund, tb.counts))


# ----------------------------------------------------------------------
# position-sharded dense and sparse inverted search
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name", ["default", "top_bit", "above_max", "wrap", "heavy"])
def test_sharded_inverted_search_matches(mesh, jmesh, name):
    mins, ab, offsets, q64, qv = _case(name)
    port, ref = _pair(mins, ab, offsets)
    inv = port.inverted
    assert inv.n_postings % N_SHARDS  # the last slice is shorter
    got_c, got_w = tdist.sharded_inverted_search(mesh, inv, *_q(q64, qv))
    assert got_c.dtype == got_w.dtype == torch.int32
    want_c, want_w = jdist.sharded_inverted_search(jmesh, ref.inverted, *_jq(q64, qv))
    one_c, one_w = tinv.inverted_search(port, *_q(q64, qv))
    assert np.array_equal(got_c.numpy(), np.asarray(want_c)) and torch.equal(got_c, one_c)
    assert np.array_equal(got_w.numpy(), np.asarray(want_w)) and torch.equal(got_w, one_w)
    assert got_c.max() >= 2
    local_n = -(-inv.n_postings // N_SHARDS)
    if name == "wrap":
        assert (got_w[got_c >= 2] < 0).any()
    if name == "heavy":  # the run straddles slice boundaries and is counted once
        assert inv.max_run == 199 > local_n  # in every one of the T = 199 targets
        assert int(got_c[0].sum()) >= 199 and int(got_c[0].max()) <= 7


def test_sharded_weight_partials_wrap_like_one_sum(mesh):
    """One (q, t) pair whose shared hashes lie in different slices, with
    abundances near 2^31: the per-shard int32 partials must add up to the
    32 bits of the whole sum."""
    span = 2**64 // 5
    hashes = (np.arange(1, 17, dtype=np.uint64) * np.uint64(span // 17)).astype(np.uint64)
    ab = np.full(16, 2**31 - 5, np.int64)
    port, ref = _pair(hashes, ab, np.array([0, 16], np.int64))
    q64, qv = hashes[None, :].copy(), np.ones((1, 16), bool)
    got_c, got_w = tdist.sharded_inverted_search(mesh, port.inverted, *_q(q64, qv))
    assert int(got_c[0, 0]) == 16
    assert int(got_w[0, 0]) == int(np.int64(ab.sum()).astype(np.int32)) != int(ab.sum())
    one_c, one_w = tinv.inverted_search(port, *_q(q64, qv))
    assert torch.equal(got_w, one_w)
    hits = tdist.sharded_sparse_search(mesh, port.inverted, *_q(q64, qv))
    assert hits.weight.tolist() == [int(ab.sum())] and hits.count.tolist() == [16]


@pytest.mark.parametrize("name", ["default", "top_bit", "wrap", "heavy"])
@pytest.mark.parametrize("expand_e", [None, 4096])
def test_sharded_sparse_search_matches(mesh, jmesh, name, expand_e):
    """Per-shard hit lists merge to the unsharded result and to the JAX
    function's, whatever its ``expand_e`` budget."""
    mins, ab, offsets, q64, qv = _case(name)
    port, ref = _pair(mins, ab, offsets)
    kw = {"run_chunk": 8} if name == "heavy" else {}
    got = tdist.sharded_sparse_search(mesh, port.inverted, *_q(q64, qv), **kw)
    want = jdist.sharded_sparse_search(jmesh, ref.inverted, *_jq(q64, qv), expand_e=expand_e, **kw)
    _same_hits(got, want)
    _same_hits(got, tsp.sparse_search(port, *_q(q64, qv)))
    assert got.n_hits > 0 and got.count.max() >= 2
    if name == "wrap":
        assert got.weight.max() > 2**31  # int64 sums: no wrap in the hit list
    if name == "heavy":
        assert got.n_hits >= 199


def test_sharded_sparse_trimmed_capacity(mesh, jmesh):
    mins, ab, offsets, q64, qv = _corpus()
    port, ref = _pair(mins, ab, offsets)
    full = tdist.sharded_sparse_search(mesh, port.inverted, *_q(q64, qv))
    got = tdist.sharded_sparse_search(mesh, port.inverted, *_q(q64, qv), capacity=10)
    want = jdist.sharded_sparse_search(jmesh, ref.inverted, *_jq(q64, qv), capacity=10)
    _same_hits(got, want)
    assert got.n_hits == full.n_hits > 10 and len(got.q) == 10
    assert np.array_equal(got.t, full.t[:10]) and np.array_equal(got.weight, full.weight[:10])


def test_sharded_sparse_sentinel_hash_and_few_postings(mesh, jmesh):
    """Seven postings over eight shards (one slice is empty), and a
    genuine query hash of u64::MAX: it matches the real postings."""
    M = 0xFFFFFFFFFFFFFFFF
    flat = np.array([5, 1000, M, 7, M, 9, M], np.uint64)
    offsets = np.array([0, 3, 5, 7], np.int64)
    ab = np.arange(1, 8, dtype=np.int64)
    names = ["a", "b", "c"]
    port = ProteomeIndex.from_arrays(IndexConfig(16, 1, "hp"), names, flat, ab, offsets, device="cpu")
    ref = JIdx(JCfg(16, 1, "hp"), names, flat, ab, offsets)
    q64, qv = np.array([[5, M]], np.uint64), np.ones((1, 2), bool)
    got = tdist.sharded_sparse_search(mesh, port.inverted, *_q(q64, qv))
    _same_hits(got, jdist.sharded_sparse_search(jmesh, ref.inverted, *_jq(q64, qv)))
    _same_hits(got, tsp.sparse_search(port, *_q(q64, qv)))
    assert got.t.tolist() == [0, 1, 2] and got.count.tolist() == [2, 1, 1]
    c, _w = tdist.sharded_inverted_search(mesh, port.inverted, *_q(q64, qv))
    assert c.tolist() == [[2, 1, 1]]


def test_sharded_search_of_an_empty_index(mesh):
    inv = tinv.build_inverted_np(np.zeros(0, np.uint64), np.zeros(0, np.int64), np.array([0, 0, 0], np.int64))
    q = torch.zeros((2, 4), dtype=torch.int64), torch.ones((2, 4), dtype=torch.bool)
    got = tdist.sharded_sparse_search(mesh, inv, *q)
    assert got.n_hits == 0 and len(got.q) == 0
    c, w = tdist.sharded_inverted_search(mesh, inv, *q)
    assert c.shape == w.shape == (2, 2) and not c.any() and not w.any()


def test_sharded_slices_are_cached_and_cleared(mesh):
    """Repeated searches against one index reuse the slices' upload; the
    slices are copies of their own, and both clear functions release them."""
    mins, ab, offsets, q64, qv = _corpus()
    port, _ref = _pair(mins, ab, offsets)
    other, _ = _pair(mins[:50], ab[:50], np.minimum(offsets, 50))
    inv = port.inverted
    tdist.clear_sharded_sparse_cache()
    a = tdist.sharded_sparse_search(mesh, inv, *_q(q64, qv))
    key = (id(inv.g_hi), id(mesh))
    assert key in tdist._SHARDED_SPARSE_CACHE
    entry_before = tdist._SHARDED_SPARSE_CACHE[key][2]
    b = tdist.sharded_sparse_search(mesh, inv, *_q(q64, qv))
    tdist.sharded_inverted_search(mesh, inv, *_q(q64, qv))
    assert tdist._SHARDED_SPARSE_CACHE[key][2] is entry_before
    _same_hits(a, b)
    slices, local_n = entry_before
    assert len(slices) == N_SHARDS and sum(s.gk.shape[0] for s in slices) == inv.n_postings
    assert all(s.bucket_starts is None and s.gk.shape[0] <= local_n for s in slices)
    whole = tinv.device_postings(inv, "cpu")
    assert torch.equal(torch.cat([s.gk for s in slices]), whole.gk)  # unsigned order kept across slices
    assert all(s.gk.data_ptr() != whole.gk[i * local_n :].data_ptr() for i, s in enumerate(slices) if s.gk.numel())
    # another mesh is another entry; a third evicts the oldest of the two slots
    tdist.sharded_sparse_search(tdist.make_mesh(3, device="cpu"), inv, *_q(q64, qv))
    tdist.sharded_sparse_search(mesh, other.inverted, *_q(q64, qv))
    assert len(tdist._SHARDED_SPARSE_CACHE) == 2 and key not in tdist._SHARDED_SPARSE_CACHE
    tdist.sharded_sparse_search(mesh, inv, *_q(q64, qv))
    held = lambda idx: any(v[0] is idx.inverted.g_hi for v in tdist._SHARDED_SPARSE_CACHE.values())  # noqa: E731
    assert held(port) and held(other)
    tdist.clear_sharded_sparse_cache(inv)
    assert not held(port) and held(other)
    tinv.clear_device_postings(other.inverted)  # the dense cache's clear releases the slices too
    assert not held(other)
    tdist.sharded_sparse_search(mesh, inv, *_q(q64, qv))
    tinv.clear_device_postings()
    assert not tdist._SHARDED_SPARSE_CACHE and not tinv._DEVICE_CACHE


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_dryrun_multichip_on_cpu_shards(n_shards, capsys):
    from kmerseek_tpu_torch.entry import dryrun_multichip

    line = dryrun_multichip(n_shards, device="cpu")
    assert line.startswith(f"dryrun_multichip ok: mesh={n_shards} shards") and line in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun_multichip(n_shards)


def test_dryrun_scale_stage_reports_the_jax_numbers(jmesh):
    """The 120,000-target stage: the port's summary suffix (postings, hit
    pairs, shard residency) is the JAX stage's, character for character."""
    import __graft_entry__

    from kmerseek_tpu_torch.entry import _dryrun_sparse_scale

    got = _dryrun_sparse_scale(tdist.make_mesh(8, device="cpu"))
    assert got == __graft_entry__._dryrun_sparse_scale(jmesh)
    assert "120000 targets / 2879967 postings, 2103 hit pairs" in got
