"""The port's plain-PyTorch murmur64 against the JAX package and the
golden vectors. Integer hashes: bit-equal (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmerseek_tpu.ops import u64 as jax_u64
from kmerseek_tpu.ops.murmur3 import murmur64_kmer_windows as jax_windows
from kmerseek_tpu_torch.ops import u64
from kmerseek_tpu_torch.ops.encoding import encode_bytes_np, get_encoding_lut, max_hash_for_scaled
from kmerseek_tpu_torch.ops.murmur3 import murmur64_bytes_py, murmur64_kmer_windows
from tests.test_murmur import GOLDEN_DAYHOFF, GOLDEN_HP, GOLDEN_PROTEIN, TEST_PROTEIN

AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)


@pytest.mark.parametrize("moltype", ["protein", "dayhoff", "hp"])
@pytest.mark.parametrize("k", [5, 8, 9, 16, 17, 24, 32, 33])
def test_windows_match_jax(moltype, k):
    rng = np.random.default_rng(k)
    seqs = encode_bytes_np(AA[rng.integers(0, 20, size=(3, 96))], moltype)
    got = u64.tensor_to_u64_np(murmur64_kmer_windows(torch.from_numpy(seqs), k))
    ref = np.asarray(jax_u64.to_py(jax_windows(jnp.asarray(seqs), k)), np.uint64)
    assert got.dtype == np.uint64 and got.shape == (3, 96 - k + 1)
    assert np.array_equal(got, ref)
    # and the scalar oracle on a sample of windows
    for b, i in [(0, 0), (1, 7), (2, 96 - k)]:
        assert int(got[b, i]) == murmur64_bytes_py(bytes(seqs[b, i : i + k]))


def test_windows_golden_vectors():
    seq = np.frombuffer(TEST_PROTEIN.encode(), np.uint8)
    for moltype, golden in [
        ("protein", [(h, p) for h, _k, p in GOLDEN_PROTEIN]),
        ("dayhoff", [(h, p) for h, _e, _o, p in GOLDEN_DAYHOFF]),
        ("hp", [(h, p) for h, _e, _o, ps in GOLDEN_HP for p in ps]),
    ]:
        enc = torch.from_numpy(encode_bytes_np(seq, moltype)[None, :])
        got = u64.tensor_to_u64_np(murmur64_kmer_windows(enc, 5))[0]
        for h, pos in golden:
            assert int(got[pos]) == h, (moltype, pos)


def test_u64_helpers():
    vals = np.array([0, 1, 2**32 - 1, 2**63 - 1, 2**63, 2**64 - 1], np.uint64)
    t = u64.u64_np_to_tensor(vals)
    assert np.array_equal(u64.tensor_to_u64_np(t), vals)
    order = torch.sort(u64.sort_key(t)).indices.numpy()
    assert np.array_equal(vals[order], np.sort(vals))
    for r in (1, 31, 33, 63):
        exp = vals >> np.uint64(r)
        assert np.array_equal(u64.tensor_to_u64_np(u64.lsr(t, r)), exp)
    mh = max_hash_for_scaled(5)
    assert mh == 3689348814741910528
    assert np.array_equal(u64.le_u64(t, mh).numpy(), vals <= np.uint64(mh))
    hi, lo = u64.split_np(vals)
    assert np.array_equal(u64.join_np(hi, lo), vals)
    assert (get_encoding_lut("hp")[AA] != ord("x")).all()
