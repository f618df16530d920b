"""The port's dense inverted engine (``ops.inverted.inverted_pair_stats``,
``inverted_search``, ``core.search._device_pair_stats``) against the JAX
package's ``inverted_pair_stats_packed`` / ``inverted_search`` /
``_device_pair_stats`` on the same postings and query block, made from a
seed with numpy. State crosses through ``ProteomeIndex.from_arrays`` on
the same CSR arrays. Integer results: tolerance 0, including the int32
wrap of the weighted sums."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmerseek_tpu.core.search as jsearch
from kmerseek_tpu.core.index import IndexConfig as JCfg
from kmerseek_tpu.core.index import ProteomeIndex as JIdx
from kmerseek_tpu.ops import inverted as jinv
from kmerseek_tpu.ops.u64 import split_np
from kmerseek_tpu_torch.core import search as tsearch
from kmerseek_tpu_torch.core.index import IndexConfig, ProteomeIndex
from kmerseek_tpu_torch.ops import inverted as tinv
from kmerseek_tpu_torch.ops.u64 import u64_np_to_tensor

CFG = (16, 5, "hp")


def _corpus(seed=11, T=300, S=24, Q=40, span=2**64 // 5, pool_size=4000, ab_lo=1, ab_hi=9):
    """CSR targets drawing from a small hash pool (so equal hashes form
    runs, max_run > 1) and a (Q, S) query block whose even slots come
    from one target's sketch (pairs share several hashes) and odd slots
    are uniform misses; duplicates masked by ``qv``."""
    rng = np.random.default_rng(seed)
    pool = np.unique(rng.integers(0, span, size=pool_size, dtype=np.uint64))
    vals = np.sort(pool[rng.integers(0, len(pool), size=(T, S))], axis=1)
    keep = np.ones_like(vals, bool)
    keep[:, 1:] = vals[:, 1:] != vals[:, :-1]
    keep[T // 2] = False  # one empty target sketch
    mins = vals[keep]
    offsets = np.concatenate([[0], np.cumsum(keep.sum(axis=1))]).astype(np.int64)
    ab = rng.integers(ab_lo, ab_hi, size=len(mins)).astype(np.int64)
    src = rng.integers(0, T, size=Q)
    q64 = np.where(
        np.arange(S)[None, :] % 2 == 0,
        vals[src][:, rng.permutation(S)],
        rng.integers(0, span, size=(Q, S), dtype=np.uint64),
    )
    q64 = np.sort(q64, axis=1)
    qv = np.ones((Q, S), bool)
    qv[:, 1:] = q64[:, 1:] != q64[:, :-1]
    return mins, ab, offsets, q64, qv


def _indexes(mins, ab, offsets):
    names = [f"t{i}" for i in range(len(offsets) - 1)]
    port = ProteomeIndex.from_arrays(IndexConfig(*CFG), names, mins, ab, offsets, device="cpu")
    return port, JIdx(JCfg(*CFG), names, mins, ab, offsets)


def _jax_search(ref, q64, qv, **kw):
    hi, lo = split_np(q64)
    c, w = jinv.inverted_search(ref, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(qv), **kw)
    return np.asarray(c), np.asarray(w)


def _port_search(port, q64, qv, **kw):
    c, w = tinv.inverted_search(port, u64_np_to_tensor(q64), torch.from_numpy(qv), **kw)
    assert c.dtype == w.dtype == torch.int32
    return c.numpy(), w.numpy()


def _case(name):
    """→ (mins, ab, offsets, q64, qv, search kwargs, check on the counts)."""
    kw, check = {}, lambda c, w: None
    if name == "top_bit":  # scaled = 1: hashes on both sides of 2^63
        mins, ab, offsets, q64, qv = _corpus(seed=12, span=2**64 - 1)
        assert (mins >= 2**63).any() and (mins < 2**63).any()
    elif name == "wrap":  # abundances near 2^31: a pair's int32 sum wraps
        mins, ab, offsets, q64, qv = _corpus(seed=13, ab_lo=2**30, ab_hi=2**31 - 1)
        check = lambda c, w: (w[c >= 2] < 0).any() or pytest.fail("no weight wrapped")  # noqa: E731
    else:
        mins, ab, offsets, q64, qv = _corpus()
    if name == "q_block":
        kw = {"q_block": 16}  # Q = 40: blocks of 16, 16, 8
    elif name == "above_max":
        # probes above every posting, up to u64::MAX - 1, in valid slots
        q64 = q64.copy()
        q64[:, -3:] = np.array([mins.max() + 1, 2**64 - 3, 2**64 - 2], np.uint64)
        qv = qv.copy()
        qv[:, -3:] = True
    elif name == "masked":
        # matching slots switched off, padding sentinels, and a duplicate
        # of a matching hash left invalid: none of them may count
        q64, qv = q64.copy(), qv.copy()
        qv[::2, ::2] = False
        q64[1, -4:] = 2**64 - 1
        qv[1, -4:] = False
        q64[3, 1] = q64[3, 0]
        qv[3, 1] = False
        q64[3] = np.sort(q64[3])
    elif name == "empty":
        mins, ab = mins[:0], ab[:0]
        offsets = np.zeros_like(offsets)
        check = lambda c, w: not c.any() or pytest.fail("counts from no postings")  # noqa: E731
    return mins, ab, offsets, q64, qv, kw, check


@pytest.mark.parametrize(
    "name", ["bucketed", "q_block", "above_max", "top_bit", "masked", "empty", "wrap", "tuple_chunks"]
)
def test_inverted_search_matches_jax(name, monkeypatch):
    mins, ab, offsets, q64, qv, kw, check = _case(name)
    port, ref = _indexes(mins, ab, offsets)
    if name == "tuple_chunks":  # run expansion in pieces of at most 7 tuples
        monkeypatch.setattr(tinv, "_DENSE_TUPLE_CHUNK", 7)
    want_c, want_w = _jax_search(ref, q64, qv, **kw)
    got_c, got_w = _port_search(port, q64, qv, **kw)
    assert got_c.shape == want_c.shape == (len(q64), len(offsets) - 1)
    assert np.array_equal(got_c, want_c)
    assert np.array_equal(got_w, want_w)
    check(got_c, got_w)
    if name not in ("empty",):
        assert port.inverted.max_run > 1 and got_c.max() >= 2


@pytest.mark.parametrize("name", ["default", "top_bit", "above_max", "wrap"])
def test_full_range_mode_matches_jax_and_bucketed(name):
    """``bucket_starts=None``: the whole array is searched, as a
    hash-range shard's slice is."""
    mins, ab, offsets, q64, qv, _kw, _check = _case(name)
    port, ref = _indexes(mins, ab, offsets)
    inv = port.inverted
    steps = max(int(inv.n_postings).bit_length(), 1)
    dp = tinv.device_postings(inv, "cpu")._replace(bucket_starts=None)
    got = tinv.inverted_pair_stats(
        dp, u64_np_to_tensor(q64), torch.from_numpy(qv),
        n_targets=inv.n_targets, max_run=inv.max_run, span_steps=steps,
    )
    hi, lo = split_np(q64)
    _binv, g4, _starts = jinv.device_postings(ref.inverted)
    want = jinv.inverted_pair_stats_packed(
        g4, None, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(qv),
        n_targets=inv.n_targets, max_run=inv.max_run, span_steps=steps,
    )
    bucketed = _port_search(port, q64, qv)
    for g, w, b in zip(got, want, bucketed):
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert np.array_equal(g.numpy(), b)


def _query_index(q64, qv):
    """The query block as CSR indexes of both packages (valid slots)."""
    counts = qv.sum(axis=1)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    mins = q64[qv]
    ab = (np.arange(len(mins)) % 5 + 1).astype(np.int64)
    names = [f"q{i}" for i in range(len(q64))]
    return (
        ProteomeIndex.from_arrays(IndexConfig(*CFG), names, mins, ab, offsets, device="cpu"),
        JIdx(JCfg(*CFG), names, mins, ab, offsets),
    )


@pytest.mark.parametrize("name", ["default", "wrap"])
def test_device_pair_stats_matches_jax_and_host_join(name):
    mins, ab, offsets, q64, qv, _kw, _check = _case(name)
    port_t, ref_t = _indexes(mins, ab, offsets)
    port_q, ref_q = _query_index(q64, qv)
    got_c, got_w = tsearch._device_pair_stats(port_q, port_t)
    want_c, want_w = jsearch._device_pair_stats(ref_q, ref_t)
    assert np.array_equal(got_c, want_c) and np.array_equal(got_w, want_w)
    # the host join's segments scattered into the same matrices
    js = tsearch._host_join(port_q, port_t, inner="ab")
    c = np.zeros_like(got_c)
    w = np.zeros(got_w.shape, np.int64)
    c[js.seg_q, js.seg_t] = js.seg_n
    w[js.seg_q, js.seg_t] = np.add.reduceat(js.pab, js.starts)
    assert np.array_equal(got_c, c)
    assert np.array_equal(got_w, w.astype(np.int32))  # int64 sums, cut to their low 32 bits


def test_clear_device_postings():
    mins, ab, offsets, q64, qv = _corpus()
    port, _ref = _indexes(mins, ab, offsets)
    other, _ = _indexes(mins[:50], ab[:50], np.minimum(offsets, 50))
    for idx in (port, other):
        tinv.device_postings(idx.inverted, "cpu")
    held = lambda idx: any(e[0] is idx.inverted.g_hi for e in tinv._DEVICE_CACHE.values())  # noqa: E731
    assert held(port) and held(other)
    tinv.clear_device_postings(port.inverted)
    assert not held(port) and held(other)
    tinv.clear_device_postings()
    assert not tinv._DEVICE_CACHE
    # a cleared index is uploaded again on the next search
    assert _port_search(port, q64, qv)[0].any() and held(port)
