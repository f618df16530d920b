"""The plain reference: murmur64, the scaled threshold, sketches, md5s,
postings and the bucket table."""

import numpy as np
import pytest

from kbench.reference import sketch

# sourmash's murmur64 (MurmurHash3 x64_128 first lane, seed 42) of these
# bytes, as the committed sourmash fixtures pin it
KNOWN = {
    b"hphphphphphphphphphphphp": 12360455331462006616,
    b"MKTAYIAKQR": 4359247334482591649,
    b"A": 16750156190880784680,
    b"ACDEFGHIKLMNPQRSTVWY": 6834785700928820991,
}


@pytest.mark.parametrize("data", sorted(KNOWN))
def test_murmur64_known_values(data):
    h = sketch.murmur64(np.frombuffer(data, np.uint8), np.array([0]), len(data))
    assert int(h[0]) == KNOWN[data]


def test_max_hash_keeps_sourmash_f64_rounding():
    assert sketch.max_hash(5) == 3689348814741910528  # not 2^64 // 5
    assert sketch.max_hash(1) == 2**64 - 1


def test_windows_hash_each_k_slice():
    data = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY" * 3, np.uint8)
    for k in (5, 10, 24):
        starts = np.arange(len(data) - k + 1)
        h = sketch.murmur64(data, starts, k)
        for s in (0, 7, len(data) - k):
            one = sketch.murmur64(np.ascontiguousarray(data[s:s + k]), np.array([0]), k)
            assert h[s] == one[0]


def test_sketch_counts_distinct_kept_windows():
    seq = b"AAAAAAAAAAAAAAAAAAAA"  # 11 equal windows at k 10
    s = sketch.sketch(["a", "b"], [seq, b"ACD"], 10, 1, "protein")
    assert list(s.offsets) == [0, 1, 1]
    assert list(s.abundances) == [11]
    h = sketch.murmur64(np.frombuffer(seq, np.uint8), np.array([0]), 10)
    assert s.mins[0] == h[0]


def test_clean_follows_kmerseek_rules():
    assert sketch.clean(b"mkbz*QQ") == b"MKDE*"
    assert sketch.clean(b"AJX") == b"AIX"
    with pytest.raises(ValueError):
        sketch.clean(b"AC1")


def test_hp_encoding_classes():
    enc = sketch.ENCODINGS["hp"][np.frombuffer(b"AFGILMPVWYCDEHKNQRST", np.uint8)]
    assert enc.tobytes() == b"h" * 10 + b"p" * 10


def test_postings_and_buckets():
    s = sketch.Sketches(["a", "b"], np.array([3, 9, 3, 5], np.uint64), np.array([1, 2, 3, 4]),
                        np.array([0, 2, 4]))
    p = sketch.postings(s)
    assert list(p.hashes) == [3, 3, 5, 9] and list(p.tid) == [0, 1, 1, 0] and list(p.ab) == [1, 3, 4, 2]
    starts, shift = sketch.bucket_table(p.hashes)
    assert shift == 32 and len(starts) == (1 << 20) + 1
    assert starts[0] == 0 and starts[1] == 4 and starts[-1] == 4


def test_md5_is_sourmash_form():
    import hashlib

    assert sketch.sourmash_md5(np.array([1, 22], np.uint64), 24) == hashlib.md5(b"72122").hexdigest()


def test_reference_agrees_with_the_port_on_the_cpu(tmp_path):
    """A witness, not the check: the port's CPU build of a tiny proteome
    gives the reference's signatures."""
    from kbench import gen
    from kmerseek_tpu_torch.core.index import IndexConfig, ProteomeIndex

    shape = {"proteins": 30, "median": 200, "sigma": 0.5, "min": 30, "max": 800, "shape_seed": 3,
             "composition": "uniprotkb-swissprot", "name_format": "p{i}"}
    fa = gen.write_fasta(str(tmp_path / "p.fa"), gen.proteome(shape, gen.rng_for(9), "x"))
    for k, scaled, moltype in ((24, 5, "hp"), (10, 1, "protein")):
        ref = sketch.sketch_fasta(fa, k, scaled, moltype)
        idx = ProteomeIndex.build(fa, IndexConfig(k, scaled, moltype), device="cpu")
        assert idx.names == ref.names
        assert np.array_equal(idx.mins, ref.mins)
        assert np.array_equal(idx.abundances, ref.abundances)
        assert np.array_equal(idx.offsets, ref.offsets)
