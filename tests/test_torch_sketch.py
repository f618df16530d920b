"""The port's sketch stage against the JAX package: the plain versions of
the two CUDA hash kernels against the Pallas kernels (interpret mode),
and the sorted sketch stage + host finalize against
``sorted_window_hashes``. Everything is integer: bit-equal (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmerseek_tpu.ops import sketch as jax_sketch
from kmerseek_tpu.ops.sketch_pallas import masked_window_keys_pallas, window_hashes_pallas
from kmerseek_tpu.ops.u64 import join_np
from kmerseek_tpu_torch.ops import sketch
from kmerseek_tpu_torch.ops.murmur3 import murmur64_bytes_py
from kmerseek_tpu_torch.ops.encoding import encode_bytes_np
from kmerseek_tpu_torch.ops.sketch_cuda import (
    masked_window_keys,
    masked_window_keys_ref,
    window_hashes,
    window_hashes_ref,
)

AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)


def _batch(seed, B, L, k):
    """Random residues; lengths cover 0, < k, = k, L and random."""
    rng = np.random.default_rng(seed)
    seqs = AA[rng.integers(0, 20, size=(B, L))]
    lens = rng.integers(0, L + 1, size=B).astype(np.int32)
    lens[:4] = [0, k - 1, k, L]
    return seqs, lens


def _u64(t):
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("moltype", ["protein", "dayhoff", "hp"])
@pytest.mark.parametrize("k,scaled", [(5, 1), (10, 1), (16, 5), (24, 5)])
def test_kernel_ref_matches_pallas(moltype, k, scaled):
    seqs, lens = _batch(k, 6, 256, k)
    keys, n_kept = masked_window_keys_ref(
        torch.from_numpy(seqs), torch.from_numpy(lens), k=k, scaled=scaled, moltype=moltype
    )
    hi, lo, cnt = masked_window_keys_pallas(
        jnp.asarray(seqs), jnp.asarray(lens), k=k, scaled=scaled, moltype=moltype,
        interpret=True,
    )
    W = 256 - k + 1
    assert keys.shape == (6, W) and keys.dtype == torch.int64
    assert np.array_equal(_u64(keys), join_np(np.asarray(hi)[:, :W], np.asarray(lo)[:, :W]))
    assert np.array_equal(n_kept.numpy(), np.asarray(cnt))
    assert n_kept[0] == 0 and n_kept[1] == 0  # lengths 0 and k-1: no windows
    # kept windows hash as the scalar oracle does
    enc = encode_bytes_np(seqs, moltype)
    h = _u64(keys)
    for b, j in zip(*np.nonzero(h != np.uint64(2**64 - 1))[:2]):
        if j % 37 == 0:
            assert int(h[b, j]) == murmur64_bytes_py(bytes(enc[b, j : j + k]))


@pytest.mark.parametrize("moltype", ["dayhoff", "hp"])
@pytest.mark.parametrize(
    "k,scaled,L",
    # the kernel's compiled k and two it runs with k at run time; window
    # counts W = L - k + 1 odd, even and 2 mod 4; one, two and four tiles' worth
    [(5, 1, 256), (10, 1, 256), (16, 5, 384), (24, 5, 384), (12, 1, 256), (40, 5, 384), (24, 5, 640), (10, 5, 1152)],
)
def test_window_hashes_cpu_route_matches_pallas(moltype, k, scaled, L):
    seqs, lens = _batch(50 + k + L, 6, L, k)
    h, keep = window_hashes(
        torch.from_numpy(seqs), torch.from_numpy(lens), k=k, scaled=scaled, moltype=moltype
    )
    ph, pk = window_hashes_pallas(
        jnp.asarray(seqs), jnp.asarray(lens), k=k, scaled=scaled, moltype=moltype,
        interpret=True,
    )
    W = L - k + 1
    assert h.shape == keep.shape == (6, W) and h.dtype == torch.int64 and keep.dtype == torch.bool
    # every window's hash, also past a row's length (rows 0..2 are shorter than L)
    assert np.array_equal(_u64(h), join_np(np.asarray(ph.hi)[:, :W], np.asarray(ph.lo)[:, :W]))
    assert np.array_equal(keep.numpy(), np.asarray(pk)[:, :W])
    assert not keep[0].any() and not keep[1].any() and keep[3].any()
    rh, rkeep = window_hashes_ref(
        torch.from_numpy(seqs), torch.from_numpy(lens), k=k, scaled=scaled, moltype=moltype
    )
    assert torch.equal(h, rh) and torch.equal(keep, rkeep)


@pytest.mark.parametrize(
    "k,scaled,capacity", [(5, 1, 512), (10, 1, 128), (16, 5, 128), (24, 5, 384)]
)
def test_sorted_window_hashes_match_jax(k, scaled, capacity):
    seqs, lens = _batch(100 + k, 8, 256, k)
    s_keys, first, n_kept = sketch.sorted_window_hashes(
        torch.from_numpy(seqs), torch.from_numpy(lens),
        k=k, scaled=scaled, moltype="hp", capacity=capacity,
    )
    s_hi, s_lo, j_first, j_n = jax_sketch.sorted_window_hashes(
        jnp.asarray(seqs), jnp.asarray(lens), k=k, scaled=scaled, moltype="hp",
        capacity=capacity, use_pallas=False,
    )
    assert np.array_equal(_u64(s_keys), join_np(np.asarray(s_hi), np.asarray(s_lo)))
    assert np.array_equal(first.numpy(), np.asarray(j_first))
    assert np.array_equal(n_kept.numpy(), np.asarray(j_n))
    if int(n_kept.max()) <= capacity:
        mins, ab = sketch.finalize_sorted_np(s_keys, first, n_kept)
        j_mins, j_ab = jax_sketch.finalize_sorted_np(s_hi, s_lo, j_first, j_n)
        for a, b, c, d in zip(mins, j_mins, ab, j_ab):
            assert np.array_equal(a, b) and np.array_equal(c, d)
    else:
        with pytest.raises(ValueError, match="capacity overflow"):
            sketch.finalize_sorted_np(s_keys, first, n_kept)


def test_sketch_capacity_matches_jax():
    for L, k, s in [(256, 5, 1), (512, 24, 5), (65536, 16, 10), (3, 5, 5)]:
        assert sketch.sketch_capacity(L, k, s) == jax_sketch.sketch_capacity(L, k, s)


def test_capacity_retry_matches_jax(monkeypatch):
    """An under-provisioned capacity doubles until every row fits; the
    signatures equal the JAX package's."""
    from kmerseek_tpu.core.index import IndexConfig as JCfg
    from kmerseek_tpu.core.index import sketch_batch_signatures as jax_sbs
    from kmerseek_tpu_torch.core import index as tindex

    rng = np.random.default_rng(9)
    seqs = [AA[rng.integers(0, 20, size=n)].tobytes() for n in (500, 480, 3, 0, 300)]
    names = [f"s{i}" for i in range(len(seqs))]
    calls = []
    real = sketch.sorted_window_hashes

    def spy(*a, **kw):
        calls.append(kw["capacity"])
        return real(*a, **kw)

    monkeypatch.setattr(sketch, "sketch_capacity", lambda *a: 1)
    monkeypatch.setattr(sketch, "sorted_window_hashes", spy)
    got = tindex.sketch_batch_signatures(
        names, seqs, tindex.IndexConfig(10, 1, "dayhoff"), device=torch.device("cpu")
    )
    assert calls == [128, 128, 256, 512]  # the 256 bucket fits at once
    ref = jax_sbs(names, seqs, JCfg(10, 1, "dayhoff"))
    for a, b in zip(got, ref):
        assert np.array_equal(a.mins, b.mins)
        assert np.array_equal(a.abundances, b.abundances)


@pytest.mark.cuda
def test_kernel_matches_ref_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for moltype in ("protein", "dayhoff", "hp"):
        for k, scaled in [(5, 1), (10, 1), (16, 5), (24, 5)]:
            seqs, lens = _batch(k, 64, 1024, k)
            s, n = torch.from_numpy(seqs).cuda(), torch.from_numpy(lens).cuda()
            a = masked_window_keys(s, n, k=k, scaled=scaled, moltype=moltype)
            b = masked_window_keys_ref(s, n, k=k, scaled=scaled, moltype=moltype)
            torch.cuda.synchronize()
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
