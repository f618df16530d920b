"""Protein signature containers (host-side metadata around device sketches).

Counterpart of ``kmerseek_tpu/core/signature.py`` (copied). Analog of
kmerseek's ``ProteinSignature`` (``signature.rs``): each protein carries a
FracMinHash sketch (sorted mins + abundances). Unlike the reference,
hashes stay in flat numpy/jnp arrays (devices hold them as (hi, lo)
uint32 pairs); the k-mer-string/position sidecar lives in a parquet
table (``core.kmers``) rather than a per-hash hashmap, mirroring the
reference's split between minhash and KmerInfo (signature.rs:110-114)
but in columnar, device-friendly form.

Conventions reproduced:
* ``minhash ksize = protein ksize * 3`` (signature.rs:13, the sourmash
  DNA-legacy convention; golden search CSV reports ksize=48 for k=16).
* sourmash md5: md5 over str(minhash_ksize) then each min's decimal
  string — verified against the committed .sig.zip fixtures.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from ..ops.encoding import max_hash_for_scaled

PROTEIN_TO_MINHASH_RATIO = 3  # signature.rs:13
SEED = 42  # signature.rs:12


def minhash_ksize(protein_ksize: int) -> int:
    return protein_ksize * PROTEIN_TO_MINHASH_RATIO


def sourmash_md5(mins: Sequence[int], protein_ksize: int) -> str:
    """sourmash KmerMinHash md5: md5(str(3k) + ''.join(str(min))).

    The digest input is built as one joined string — per-min hash
    updates cost ~1M C calls per 20k-signature corpus."""
    arr = np.asarray(mins, dtype=np.uint64)
    blob = str(minhash_ksize(protein_ksize)) + "".join(map(str, arr.tolist()))
    return hashlib.md5(blob.encode()).hexdigest()


def sourmash_md5s(mins: np.ndarray, offsets: np.ndarray, protein_ksize: int) -> List[str]:
    """``sourmash_md5`` of every signature of CSR arrays (``mins`` with
    ``offsets``). With the native library, the decimal text of a piece of
    about 1M mins is made at once (``native.decimal_u64``) and each
    signature's md5 taken over its slice of it; without it, one
    ``sourmash_md5`` a signature."""
    from .. import native

    mins = np.asarray(mins, np.uint64)
    offsets = np.asarray(offsets, np.int64)
    if not native.available():
        return [sourmash_md5(mins[a:b], protein_ksize) for a, b in zip(offsets[:-1], offsets[1:])]
    prefix = str(minhash_ksize(protein_ksize)).encode()
    out: List[str] = []
    s0, n = 0, len(offsets) - 1
    while s0 < n:
        base = int(offsets[s0])
        s1 = min(max(int(np.searchsorted(offsets, base + (1 << 20), "right")) - 1, s0 + 1), n)
        text, ends = native.decimal_u64(mins[base:offsets[s1]])
        text = memoryview(text)
        cuts = np.concatenate([[0], ends])[offsets[s0:s1 + 1] - base].tolist()
        for a, b in zip(cuts[:-1], cuts[1:]):
            h = hashlib.md5(prefix)
            h.update(text[a:b])
            out.append(h.hexdigest())
        s0 = s1
    return out


def mins_sum_hex(mins: Sequence[int]) -> str:
    """kmerseek-Rust's 'md5': hex of the wrapping u64 sum of the mins
    (``signature.rs``); not a real md5, kept for oracle parity."""
    total = 0
    for x in np.asarray(mins, dtype=np.uint64):
        total = (total + int(x)) & ((1 << 64) - 1)
    return f"{total:x}"


@dataclass
class Signature:
    """One protein's sketch + metadata."""

    name: str
    mins: np.ndarray  # uint64, sorted ascending
    abundances: np.ndarray  # int64
    ksize: int  # protein ksize
    scaled: int
    moltype: str
    filename: str = ""
    _md5: Optional[str] = field(default=None, repr=False)

    def __post_init__(self):
        self.mins = np.asarray(self.mins, dtype=np.uint64)
        self.abundances = np.asarray(self.abundances, dtype=np.int64)
        assert self.mins.shape == self.abundances.shape

    @property
    def md5sum(self) -> str:
        if self._md5 is None:
            self._md5 = sourmash_md5(self.mins, self.ksize)
        return self._md5

    @property
    def md5short(self) -> str:
        return self.md5sum[:8]

    @property
    def max_hash(self) -> int:
        return max_hash_for_scaled(self.scaled)

    @property
    def n_hashes(self) -> int:
        return len(self.mins)

    def __len__(self) -> int:
        return len(self.mins)


def signatures_from_sketch_batch(
    batch,
    names: Sequence[str],
    *,
    ksize: int,
    scaled: int,
    moltype: str,
    filename: str = "",
) -> List[Signature]:
    """Convert a device ``ops.sketch.SketchBatch`` into host Signatures.

    Raises on an under-provisioned capacity: a row whose kept windows
    (``n_kept``) outnumber the slots lost some of them."""
    counts = batch.counts.cpu().numpy()
    mins = batch.mins.cpu().numpy().view(np.uint64)
    abund = batch.abund.cpu().numpy()
    n_kept = batch.n_kept.cpu().numpy()
    cap = mins.shape[1]
    if n_kept.max(initial=0) > cap:
        raise ValueError(
            f"sketch capacity overflow: max kept {n_kept.max()} > capacity {cap}"
        )
    out = []
    for i, name in enumerate(names):
        n = int(counts[i])
        out.append(
            Signature(
                name=name,
                mins=mins[i, :n],
                abundances=abund[i, :n].astype(np.int64),
                ksize=ksize,
                scaled=scaled,
                moltype=moltype,
                filename=filename,
            )
        )
    return out
