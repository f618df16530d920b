"""The traffic generator is a function of the seed, and every seed gets
the same sizes."""

import numpy as np

from kbench import gen

COMP = "uniprotkb-swissprot"
SHAPE = {"proteins": 50, "median": 280, "sigma": 0.6, "min": 30, "max": 5000, "shape_seed": 2,
         "composition": COMP, "name_format": "p{i}"}
BLOCK = {"size": 16, "min_len": 50, "max_len": 300, "planted_share": 0.5, "substitution": 0.215,
         "composition": COMP, "shape_seed": 1}


def test_proteome_is_deterministic_per_seed():
    a = gen.proteome(SHAPE, gen.rng_for(2**31 + 5), "x")
    b = gen.proteome(SHAPE, gen.rng_for(2**31 + 5), "x")
    c = gen.proteome(SHAPE, gen.rng_for(2**31 + 6), "x")
    assert a.buf == b.buf and np.array_equal(a.offsets, b.offsets)
    assert a.buf != c.buf
    assert sorted(a.lengths) == sorted(c.lengths)  # same sizes, another order


def test_residues_follow_the_composition():
    want = np.diff(np.concatenate([[0.0], gen.composition(COMP)]))
    got = np.bincount(np.searchsorted(gen.AA, gen.residues(gen.rng_for(3), 400_000, COMP)), minlength=20)
    assert np.abs(got / got.sum() - want).max() < 0.002
    assert abs(want[list(gen.AA).index(ord("L"))] - 9.65 / 99.91) < 1e-12


def test_query_blocks_are_deterministic_and_planted():
    t = gen.proteome(SHAPE, gen.rng_for(1), "t")
    a, a2 = gen.query_blocks(t, BLOCK, gen.rng_for(7), 2)
    b, _ = gen.query_blocks(t, BLOCK, gen.rng_for(7), 2)
    c, _ = gen.query_blocks(t, BLOCK, gen.rng_for(8), 2)
    assert a.names == b.names and a.buf == b.buf and a.buf != c.buf and a.buf != a2.buf
    assert sorted(a.lengths) == sorted(c.lengths) == sorted(a2.lengths)
    planted = [i for i, n in enumerate(a.names) if "homolog" in n]
    assert len(planted) == 8
    same = total = 0
    for i in planted:  # a homolog is its source's segment at the stated identity
        src = int(a.names[i].rsplit("p", 1)[1])
        q = np.frombuffer(a.seq(i), np.uint8)
        s = np.frombuffer(t.seq(src), np.uint8)
        best = max(int((q == s[o:o + len(q)]).sum()) for o in range(len(s) - len(q) + 1))
        same, total = same + best, total + len(q)
    assert abs(same / total - (1 - BLOCK["substitution"])) < 0.03


def test_seed_larger_than_32_bits():
    assert gen.rng_for(2**33 + 1).integers(0, 10) == gen.rng_for(2**33 + 1).integers(0, 10)
