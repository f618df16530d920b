"""The one traffic generator: seeded synthetic proteomes and query blocks
from the parameters of a configuration or traffic file.

Sizes come from the file's own ``shape_seed``, so every run seed gets the
same multiset of protein and query lengths, in another order; the
residues, the planted sources and the substitutions come from the run
seed. Residues are drawn independently in the proportions of a published
amino acid composition (``kbench/compositions/<name>.json``, named by the
shape's ``composition``).
"""

from __future__ import annotations

import functools
import json
import math
import os
from typing import Iterator, List, NamedTuple

import numpy as np

AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
LINE = 60  # residues per FASTA line, as UniProt writes them
COMPOSITIONS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "compositions")


@functools.lru_cache(maxsize=None)
def composition(name: str) -> np.ndarray:
    """Cumulative probabilities of the 20 residues of ``AA`` in the named
    composition, normalised to 1."""
    with open(os.path.join(COMPOSITIONS, f"{name}.json")) as f:
        pct = json.load(f)["percent"]
    p = np.array([pct[chr(a)] for a in AA], np.float64)
    return np.cumsum(p / p.sum())


def residues(rng: np.random.Generator, n: int, comp: str) -> np.ndarray:
    """``n`` residue codes drawn independently in the composition's
    proportions."""
    cum = composition(comp)
    return AA[np.minimum(np.searchsorted(cum, rng.random(n), "right"), len(AA) - 1)]


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed & (2**64 - 1), *stream])


class Proteome(NamedTuple):
    names: List[str]
    buf: bytes  # every residue, proteins back to back
    offsets: np.ndarray  # (n + 1,) int64

    def seq(self, i: int) -> bytes:
        return self.buf[self.offsets[i]:self.offsets[i + 1]]

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)


def shape_lengths(shape: dict) -> np.ndarray:
    """Protein lengths: lognormal (``median``, ``sigma``) clipped to
    [``min``, ``max``], and ``giants`` of them drawn uniformly from
    [``giant_min``, ``giant_max``]."""
    rng = np.random.default_rng(shape["shape_seed"])
    n = shape["proteins"]
    lens = np.clip(rng.lognormal(math.log(shape["median"]), shape["sigma"], size=n),
                   shape["min"], shape["max"]).astype(np.int64)
    g = shape.get("giants", 0)
    if g:
        lens[rng.choice(n, size=g, replace=False)] = rng.integers(
            shape["giant_min"], shape["giant_max"] + 1, size=g)
    return lens


def proteome(shape: dict, rng: np.random.Generator, tag: str) -> Proteome:
    lens = rng.permutation(shape_lengths(shape))
    buf = residues(rng, int(lens.sum()), shape["composition"]).tobytes()
    offsets = np.concatenate([[0], np.cumsum(lens)])
    fmt = shape["name_format"]
    return Proteome([fmt.format(i=i, tag=tag) for i in range(len(lens))], buf, offsets)


def query_blocks(target: Proteome, block: dict, rng: np.random.Generator,
                 count: int) -> Iterator[Proteome]:
    """``count`` blocks of ``block["size"]`` queries of
    ``block["min_len"]..block["max_len"]`` residues. A ``planted_share``
    of each block are homologs: segments of targets at least as long, each
    residue replaced at ``substitution`` rate by a different residue drawn
    from the composition. The rest are unrelated: drawn from the
    composition. The composition is the block's ``composition``."""
    size, comp = block["size"], block["composition"]
    shape = np.random.default_rng(block["shape_seed"]).integers(
        block["min_len"], block["max_len"] + 1, size=size)
    tl = target.lengths
    by_len = np.argsort(tl, kind="stable")
    sorted_len = tl[by_len]
    tbuf = np.frombuffer(target.buf, np.uint8)
    for b in range(count):
        perm = rng.permutation(size)
        lens = shape[perm]
        offsets = np.concatenate([[0], np.cumsum(lens)])
        pl = np.flatnonzero(perm < round(size * block["planted_share"]))
        n = lens[pl]
        # a source at least as long as the segment, uniform among those
        lo = np.searchsorted(sorted_len, n, "left")
        t = by_len[lo + (rng.random(len(pl)) * (len(tl) - lo)).astype(np.int64)]
        a = target.offsets[t] + (rng.random(len(pl)) * (tl[t] - n + 1)).astype(np.int64)
        out = residues(rng, int(offsets[-1]), comp)
        within = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
        seg = tbuf[np.repeat(a, n) + within]
        sub = np.flatnonzero(rng.random(len(seg)) < block["substitution"])
        new = residues(rng, len(sub), comp)
        same = np.flatnonzero(new == seg[sub])
        while len(same):  # a substitution changes the residue
            new[same] = residues(rng, len(same), comp)
            same = same[new[same] == seg[sub[same]]]
        seg[sub] = new
        out[np.repeat(offsets[pl], n) + within] = seg
        src = dict(zip(pl.tolist(), t.tolist()))
        names = [f"b{b}q{j} homolog of {target.names[src[j]].split()[0]}" if j in src
                 else f"b{b}q{j} unrelated" for j in range(size)]
        yield Proteome(names, out.tobytes(), offsets)


def write_fasta(path: str, p: Proteome) -> str:
    out = []
    for i, name in enumerate(p.names):
        a, b = int(p.offsets[i]), int(p.offsets[i + 1])
        out.append(f">{name}\n".encode())
        out.extend(p.buf[j:min(j + LINE, b)] + b"\n" for j in range(a, b, LINE))
    with open(path, "wb") as f:
        f.write(b"".join(out))
    return os.path.abspath(path)
