"""The port's ProteomeIndex against the JAX package's: the build on a
seeded FASTA, ``.ksx`` written by each side and loaded by the other,
and ``.sig.zip`` bytes. Bit-equal (tolerance 0)."""

import numpy as np
import pytest

from kmerseek_tpu.core.index import IndexConfig as JaxConfig
from kmerseek_tpu.core.index import ProteomeIndex as JaxIndex
from kmerseek_tpu_torch.core.index import IndexConfig, ProteomeIndex

AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)


def write_fasta(path, n=20, seed=0, max_len=500):
    """Seeded FASTA: random proteins of length 0..max_len, a duplicated
    record, a lowercase/ambiguous/stop-codon record and a comma name."""
    rng = np.random.default_rng(seed)
    seqs = [AA[rng.integers(0, 20, rng.integers(0, max_len))].tobytes() for _ in range(n)]
    seqs[3] = seqs[2]
    seqs[4] = b"mkvbzjlaac" + seqs[4] + b"*QQQQ"
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">sp|P{i:05d}|T{i}_HUMAN protein {i}, isoform\n")
            for j in range(0, len(s), 60):
                f.write(s[j : j + 60].decode() + "\n")
    return seqs


def _assert_same(a, b):
    assert list(a.names) == list(b.names)
    assert np.array_equal(a.mins, b.mins)
    assert np.array_equal(a.abundances, b.abundances)
    assert np.array_equal(a.offsets, b.offsets)
    for x, y in zip(a.combined, b.combined):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("moltype,k,scaled", [("hp", 24, 5), ("protein", 5, 1)])
def test_build_save_load_match_jax(tmp_path, moltype, k, scaled):
    fasta = str(tmp_path / "t.fa")
    write_fasta(fasta, seed=k)
    port = ProteomeIndex.build(fasta, IndexConfig(k, scaled, moltype), device="cpu")
    ref = JaxIndex.build(fasta, JaxConfig(k, scaled, moltype), engine="device")
    _assert_same(port, ref)
    assert [port.md5_for(i) for i in range(len(port))] == [
        ref.md5_for(i) for i in range(len(ref))
    ]

    # .ksx written by the port loads in the JAX package, and back
    port.save(str(tmp_path / "port.ksx"))
    ref.save(str(tmp_path / "jax.ksx"))
    j_from_port = JaxIndex.load(str(tmp_path / "port.ksx"))
    p_from_jax = ProteomeIndex.load(str(tmp_path / "jax.ksx"), device="cpu")
    _assert_same(j_from_port, ref)
    _assert_same(p_from_jax, port)
    for inv_a, inv_b in [
        (j_from_port.inverted, ref.inverted),
        (p_from_jax.inverted, port.inverted),
    ]:
        for f in ("g_hi", "g_lo", "tid", "ab", "bucket_starts"):
            assert np.array_equal(getattr(inv_a, f), getattr(inv_b, f)), f
        assert (inv_a.max_run, inv_a.max_span, inv_a.bucket_shift) == (
            inv_b.max_run, inv_b.max_span, inv_b.bucket_shift,
        )

    # .sig.zip bytes
    port.to_sig_zip(str(tmp_path / "port.sig.zip"))
    ref.to_sig_zip(str(tmp_path / "jax.sig.zip"))
    assert (tmp_path / "port.sig.zip").read_bytes() == (tmp_path / "jax.sig.zip").read_bytes()
    from kmerseek_tpu_torch.core.sigzip import read_sig_zip

    back = read_sig_zip(str(tmp_path / "jax.sig.zip"))
    assert [s.name for s in back] == ref.names
    for i, s in enumerate(back):
        assert np.array_equal(s.mins, ref.signature(i).mins)
        assert np.array_equal(s.abundances, ref.signature(i).abundances)
        assert (s.ksize, s.scaled, s.moltype) == (k, scaled, moltype)


def test_from_arrays_takes_jax_csr():
    rng = np.random.default_rng(4)
    mins = np.sort(rng.integers(0, 2**64, size=12, dtype=np.uint64))
    ab = rng.integers(1, 5, size=12)
    offsets = np.array([0, 5, 5, 12])
    idx = ProteomeIndex.from_arrays(
        IndexConfig(16, 5, "hp"), ["a", "b", "c"], mins, ab, offsets, device="cpu"
    )
    ref = JaxIndex(JaxConfig(16, 5, "hp"), ["a", "b", "c"], mins, ab, offsets)
    _assert_same(idx, ref)
    assert idx.counts.tolist() == [5, 0, 7]


def test_invalid_residue_fails_build(tmp_path):
    from kmerseek_tpu_torch.core.alphabet import InvalidAminoAcid

    fasta = tmp_path / "bad.fa"
    fasta.write_text(">ok\nMKV\n>bad\nMK1V\n")
    with pytest.raises(InvalidAminoAcid, match="'1' at position 3"):
        ProteomeIndex.build(str(fasta), device="cpu")
