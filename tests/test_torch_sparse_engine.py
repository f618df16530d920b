"""The port's sparse hit-list engine (``ops.sparse_search``) against the
JAX package's on the same postings and query blocks, made from a seed
with numpy: the device hit function ``inverted_sparse_hits`` and its
chunked form slot for slot (rectangular and compact expansion, wide and
narrow weights, run-offset tiles, overflow, run-length lookup), the run
lengths, the undersized-budget retry, a u64::MAX run, the host route,
the stream and the warm-up. Integer results: tolerance 0. A last test
shows that a launch makes no host sync."""

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


def _pair(mins, ab, offsets):
    names = [f"t{i}" for i in range(len(offsets) - 1)]
    port = ProteomeIndex.from_arrays(IndexConfig(*CFG), names, mins, ab, offsets, device="cpu")
    return port, JIdx(JCfg(*CFG), names, mins, ab, offsets)


def _tq(q64, qv):
    return u64_np_to_tensor(q64), torch.from_numpy(np.asarray(qv))


def _jq(q64, qv):
    hi, lo = split_np(q64)
    return jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(qv)


def _same_hits(got, want):
    assert got.n_hits == int(want.n_hits)
    for f in ("q", "t", "count", "weight"):
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert np.array_equal(g, w), f
    assert got.q.dtype == got.t.dtype == got.count.dtype == np.int32 and got.weight.dtype == np.int64


@pytest.fixture(autouse=True)
def _fresh_caches():
    for mod in (tsp, jsp):
        mod._EXPAND_CACHE.clear()
        mod._HP_CACHE.clear()
    yield


def _kernel_pair(port, ref, **kw):
    """The same postings for both functions: (port dp, JAX g4 + table)."""
    dp = tinv.device_postings(port.inverted, "cpu")
    _binv, g4, starts = jinv.device_postings(ref.inverted)
    inv = port.inverted
    base = dict(
        n_targets=inv.n_targets, span_steps=max(int(inv.max_span).bit_length(), 1),
        bucket_shift=inv.bucket_shift,
    )
    return dp, g4, starts, dict(base, **kw)


CASES = {
    "rect": dict(expand_e=None),
    "compact": dict(expand_e=4096),
    "compact_narrow": dict(expand_e=4096, wide_weights=False),
    "rect_narrow": dict(expand_e=None, wide_weights=False),
    "tile": dict(expand_e=2048, max_run=2, run_offset=2),
    "tile_rect": dict(expand_e=None, max_run=2, run_offset=1),
    "overflow": dict(expand_e=4096, capacity=128),
    "undersized_e": dict(expand_e=128),
    "rl": dict(expand_e=4096, rl=True),
    "rl_tile": dict(expand_e=4096, rl=True, max_run=2, run_offset=3),
}


# the narrow weight layout is only taken where it cannot wrap: not with
# abundances near 2^31
@pytest.mark.parametrize(
    "case,corpus",
    [(c, "default") for c in sorted(CASES)]
    + [(c, "heavy_ab") for c in sorted(CASES) if CASES[c].get("wide_weights", True)],
)
def test_inverted_sparse_hits_matches_jax(case, corpus):
    kw = dict(CASES[case])
    if corpus == "heavy_ab":  # abundances near 2^31: limb sums past int32
        mins, ab, offsets, q64, qv = _corpus(seed=21, ab_lo=2**30, ab_hi=2**31 - 1)
    else:
        mins, ab, offsets, q64, qv = _corpus(seed=22)
    port, ref = _pair(mins, ab, offsets)
    use_rl = kw.pop("rl", False)
    kw.setdefault("max_run", port.inverted.max_run)
    kw.setdefault("capacity", 4096)
    kw["true_max_run"] = port.inverted.max_run
    dp, g4, starts, kw = _kernel_pair(port, ref, **kw)
    t_rl = tsp.device_run_lengths(port.inverted, "cpu") if use_rl else None
    j_rl = jsp.device_run_lengths(ref.inverted) if use_rl else None
    got = tsp.inverted_sparse_hits(dp, *_tq(q64, qv), t_rl, **kw)
    want = jsp.inverted_sparse_hits(g4, starts, *_jq(q64, qv), j_rl, **kw)
    names = ("q_out", "t_out", "counts", "weights", "stats")
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.int32, name
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    n, m = (int(v) for v in got[4])
    assert n > 0
    if case == "overflow":
        assert n > kw["capacity"]
    if case == "undersized_e":
        assert m > kw["expand_e"]  # what the finish sees and retries


@pytest.mark.parametrize("expand_e", [None, 2048])
def test_inverted_sparse_hits_chunks_matches_jax(expand_e):
    mins, ab, offsets, q64, qv = _corpus(seed=23, Q=48)
    port, ref = _pair(mins, ab, offsets)
    dp, g4, starts, kw = _kernel_pair(
        port, ref, max_run=port.inverted.max_run, capacity=1024, expand_e=expand_e,
        true_max_run=port.inverted.max_run,
    )
    C, Qc = 4, 12
    tk, tv = _tq(q64, qv)
    hi, lo = split_np(q64)
    got = tsp.inverted_sparse_hits_chunks(dp, tk.view(C, Qc, -1), tv.view(C, Qc, -1), **kw)
    want = jsp.inverted_sparse_hits_chunks(
        g4, starts, *(jnp.asarray(a.reshape(C, Qc, -1)) for a in (hi, lo, qv)), **kw
    )
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert got[4].shape == (C, 2) and got[0].shape == (C, 1024) and got[3].shape == (C, 1024, 2)


def test_compact_guard_raises():
    mins, ab, offsets, q64, qv = _corpus(seed=24)
    port, _ref = _pair(mins, ab, offsets)
    dp = tinv.device_postings(port.inverted, "cpu")
    with pytest.raises(ValueError, match="compact expansion overflow risk"):
        tsp.inverted_sparse_hits(
            dp, *_tq(q64, qv), n_targets=port.inverted.n_targets, max_run=2**31 // (40 * 24) + 1,
            capacity=128, span_steps=8, expand_e=128,
        )


def test_device_run_lengths_matches_jax_and_caches():
    mins, ab, offsets, _q, _v = _corpus(seed=25)
    port, ref = _pair(mins, ab, offsets)
    got = tsp.device_run_lengths(port.inverted, "cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(jsp.device_run_lengths(ref.inverted)))
    assert int(got.max()) == port.inverted.max_run > 1
    assert tsp.device_run_lengths(port.inverted, "cpu") is got
    # a device-built index keys the cache on its own postings
    dev = tinv.build_inverted_dev(mins, ab, offsets, "cpu")
    assert torch.equal(tsp.device_run_lengths(dev), got) and dev._host_cols is None


def test_undersized_budget_retries_exact():
    """A learned E far below the block's match total: the result is the
    exact one, and E is relearned above the total, in both packages."""
    mins, ab, offsets, q64, qv = _corpus(seed=26)
    port, ref = _pair(mins, ab, offsets)
    Q, S = q64.shape
    tsp.seed_learned_hints(port.inverted, {"expand": {f"{Q},{S}": 128}})
    jsp.seed_learned_hints(ref.inverted, {"expand": {f"{Q},{S}": 128}})
    got = tsp.sparse_search(port, *_tq(q64, qv))
    _same_hits(got, jsp.sparse_search(ref, *_jq(q64, qv)))
    e = tsp.export_learned_hints(port.inverted)["expand"][f"{Q},{S}"]
    assert e > 128 and e == jsp.export_learned_hints(ref.inverted)["expand"][f"{Q},{S}"]
    assert int(got.count.sum()) > 128


def test_u64_max_hash_run():
    """A posting hash of u64::MAX (the JAX engine's wrapped upper bound):
    the run is counted exactly, and the result is the JAX engine's."""
    M = 0xFFFFFFFFFFFFFFFF
    flat = np.array([5, 1000, M, 7, M, 9, M], dtype=np.uint64)
    offsets = np.array([0, 3, 5, 7], np.int64)
    ab = np.arange(1, len(flat) + 1, dtype=np.int64)
    port, ref = _pair(flat, ab, offsets)
    q64 = np.array([[5, M]], dtype=np.uint64)
    qv = np.ones((1, 2), bool)
    got = tsp.sparse_search(port, *_tq(q64, qv))
    assert {
        (int(q), int(t)): (int(c), int(w)) for q, t, c, w in zip(got.q, got.t, got.count, got.weight)
    } == {(0, 0): (2, 1 + 3), (0, 1): (1, 5), (0, 2): (1, 7)}
    _same_hits(got, jsp.sparse_search(ref, *_jq(q64, qv)))
    # a tile narrower than the run keeps every run inside [pos, pos + max_run]
    _same_hits(tsp.sparse_search(port, *_tq(q64, qv), run_chunk=1), got)
    _same_hits(tsp.sparse_search_host(port, *_tq(q64, qv)), got)


@pytest.mark.parametrize(
    "kw", [{}, {"capacity": 50}, {"q_chunk": 16}, {"run_chunk": 2}, {"q_chunk": 12, "run_chunk": 3}]
)
def test_sparse_search_host_matches(kw):
    mins, ab, offsets, q64, qv = _corpus(seed=27)
    port, ref = _pair(mins, ab, offsets)
    dev = tsp.sparse_search(port, *_tq(q64, qv), **kw)
    _same_hits(dev, jsp.sparse_search(ref, *_jq(q64, qv), **kw))
    cap = kw.get("capacity")
    host = tsp.sparse_search_host(port, q64.view(np.int64), qv, capacity=cap)
    _same_hits(host, jsp.sparse_search_host(ref, *_jq(q64, qv), capacity=cap))
    if cap is None:
        _same_hits(host, dev)
    else:
        assert host.n_hits == dev.n_hits > cap and len(host.q) == cap


@pytest.mark.parametrize("chunk_cap_floor", [None, 128])
def test_chunked_search_matches_jax_with_overflow(monkeypatch, chunk_cap_floor):
    """The chunked launch (C_pad = 4 for 3 chunks), with the per-chunk
    auto capacity forced below a chunk's hits: the exact retry."""
    mins, ab, offsets, q64, qv = _corpus(seed=28, Q=36)
    port, ref = _pair(mins, ab, offsets)
    if chunk_cap_floor is not None:
        monkeypatch.setattr(tsp, "_CHUNK_CAP_FLOOR", chunk_cap_floor)
        monkeypatch.setattr(jsp, "_CHUNK_CAP_FLOOR", chunk_cap_floor)
        monkeypatch.setattr(tsp, "_SCAN_SLOT_BUDGET", 4 * chunk_cap_floor)
        monkeypatch.setattr(jsp, "_SCAN_SLOT_BUDGET", 4 * chunk_cap_floor)
    got = tsp.sparse_search(port, *_tq(q64, qv), q_chunk=12)
    _same_hits(got, jsp.sparse_search(ref, *_jq(q64, qv), q_chunk=12))
    assert tsp.export_learned_hints(port.inverted) == jsp.export_learned_hints(ref.inverted)
    assert any(k.startswith("4,12,") for k in tsp.export_learned_hints(port.inverted)["hp"])


def _blocks(q64, qv, sizes):
    out, a = [], 0
    for n in sizes:
        out.append((q64[a : a + n], qv[a : a + n]))
        a += n
    return out


def test_sparse_search_stream_matches():
    """Blocks in flight one at a time, with a chunked block (above
    ``q_chunk``) in the middle: each equals its own ``sparse_search`` and
    the JAX stream's."""
    mins, ab, offsets, q64, qv = _corpus(seed=29, Q=60)
    port, ref = _pair(mins, ab, offsets)
    blocks = _blocks(q64, qv, [10, 10, 25, 10, 5])
    got = list(tsp.sparse_search_stream(port, (_tq(a, b) for a, b in blocks), q_chunk=16))
    want = list(jsp.sparse_search_stream(ref, (_jq(a, b) for a, b in blocks), q_chunk=16))
    assert len(got) == len(want) == 5
    for g, w, (a, b) in zip(got, want, blocks):
        _same_hits(g, w)
        _same_hits(g, tsp.sparse_search(port, *_tq(a, b), q_chunk=16))
    assert tsp.export_learned_hints(port.inverted) == jsp.export_learned_hints(ref.inverted)


def test_sparse_search_stream_empty_and_single():
    mins, ab, offsets, q64, qv = _corpus(seed=30)
    port, ref = _pair(mins, ab, offsets)
    assert list(tsp.sparse_search_stream(port, iter([]))) == []
    (one,) = tsp.sparse_search_stream(port, [_tq(q64, qv)])
    _same_hits(one, tsp.sparse_search(port, *_tq(q64, qv)))
    (jone,) = jsp.sparse_search_stream(ref, [_jq(q64, qv)])
    _same_hits(one, jone)
    # an index without postings: every block is empty
    empty, _r = _pair(np.zeros(0, np.uint64), np.zeros(0, np.int64), np.zeros(3, np.int64))
    (none,) = tsp.sparse_search_stream(empty, [_tq(q64, qv)])
    assert none.n_hits == 0 and len(none.q) == 0


def test_warm_sparse_engine_does_not_poison_hints():
    mins, ab, offsets, q64, qv = _corpus(seed=31)
    port, ref = _pair(mins, ab, offsets)
    tsp.sparse_search(port, *_tq(q64, qv))
    jsp.sparse_search(ref, *_jq(q64, qv))
    before = tsp.export_learned_hints(port.inverted)
    assert before == jsp.export_learned_hints(ref.inverted) and before["expand"]
    assert tsp.warm_sparse_engine(port, q64.shape) is True
    assert jsp.warm_sparse_engine(ref, q64.shape) is True
    assert tsp.export_learned_hints(port.inverted) == before == jsp.export_learned_hints(ref.inverted)
    assert tsp.warm_sparse_engine(port, (40, 24), q_chunk=16, device="cpu") is True
    assert tsp.export_learned_hints(port.inverted) == before
    assert not getattr(tsp._warming_state, "active", False)


def test_sparse_launch_makes_no_host_sync(monkeypatch):
    """Every way a tensor reaches the host (``item``, ``tolist``,
    ``numpy``, ``cpu``, truth value, a boolean-mask index, ``nonzero``,
    ``repeat_interleave`` without ``output_size``) is counted while
    ``_sparse_launch`` and the chunked launch run: none may happen. The
    finish then reads the result."""
    mins, ab, offsets, q64, qv = _corpus(seed=32)
    port, ref = _pair(mins, ab, offsets)
    tk, tv = _tq(q64, qv)
    inv = port.inverted
    tsp.sparse_search(port, tk, tv)  # learned hints: the launch also starts the trimmed fetch
    tinv.device_postings(inv, "cpu")
    syncs = []
    T = torch.Tensor

    def counting(name, orig):
        def f(*a, **k):
            syncs.append(name)
            return orig(*a, **k)

        return f

    for name in ("item", "tolist", "numpy", "cpu", "__bool__", "__int__", "__index__", "nonzero"):
        monkeypatch.setattr(T, name, counting(name, getattr(T, name)))
    monkeypatch.setattr(torch, "nonzero", counting("torch.nonzero", torch.nonzero))
    orig_getitem, orig_ri = T.__getitem__, torch.repeat_interleave

    def getitem(self, idx):
        parts = idx if isinstance(idx, tuple) else (idx,)
        if any(isinstance(p, torch.Tensor) and p.dtype == torch.bool for p in parts):
            syncs.append("mask index")
        return orig_getitem(self, idx)

    def repeat_interleave(*a, **k):
        if "output_size" not in k:
            syncs.append("repeat_interleave")
        return orig_ri(*a, **k)

    monkeypatch.setattr(T, "__getitem__", getitem)
    monkeypatch.setattr(torch, "repeat_interleave", repeat_interleave)
    st = tsp._sparse_launch(inv, tk, tv, None, inv.max_run)
    C = 4
    chunks = (tk.view(C, -1, tk.shape[1]), tv.view(C, -1, tv.shape[1]))
    dp = tinv.device_postings(inv, "cpu")
    tsp.inverted_sparse_hits_chunks(
        dp, *chunks, n_targets=inv.n_targets, max_run=inv.max_run, capacity=256,
        span_steps=max(inv.max_span.bit_length(), 1), bucket_shift=inv.bucket_shift, expand_e=1024,
    )
    assert syncs == []
    assert st["hv"] is not None  # the launch started the trimmed fetch too
    monkeypatch.undo()
    _same_hits(tsp._sparse_finish(inv, st), jsp.sparse_search(ref, *_jq(q64, qv)))
