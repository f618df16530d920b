"""Host-side sequence validation and ambiguity resolution (vectorized).

Counterpart of ``kmerseek_tpu/core/alphabet.py`` (copied). Reproduces
kmerseek's ``aminoacid.rs`` semantics:

* sequences are uppercased before validation (index.rs:999-1000);
* the 20 standard AAs plus ``X U O *`` and ambiguity codes ``B Z J``
  are valid; anything else raises with the offending char and a 1-based
  position (aminoacid.rs:58-69), and — like ``process_fasta``
  (index.rs:2272-2282) — one bad record fails the whole file;
* processing stops at the first stop codon ``*`` which is itself kept
  (aminoacid.rs:74-105 pushes '*' then breaks);
* B→{D,N}, Z→{E,Q}, J→{I,L}. The reference resolves randomly
  (aminoacid.rs:45-54) making such sketches nondeterministic; here the
  default policy is the deterministic first candidate (B→D, Z→E, J→I),
  with an optional seeded-random policy for reference-like behavior.
  Documented divergence from the reference.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..ops.encoding import (
    AMBIGUITY_CHOICES,
    RESOLVE_FIRST_LUT,
    UPPER_LUT,
    VALID_LUT,
)


class InvalidAminoAcid(ValueError):
    """Invalid amino acid: carries char and 1-based position (errors.rs:3-55)."""

    def __init__(self, char: str, position: int, name: Optional[str] = None):
        self.char = char
        self.position = position
        self.name = name
        where = f" in sequence '{name}'" if name else ""
        super().__init__(f"Invalid amino acid '{char}' at position {position}{where}")


def validate_resolve(
    seq: bytes,
    name: Optional[str] = None,
    policy: str = "first",
    rng: Optional[np.random.Generator] = None,
) -> bytes:
    """Uppercase, validate, resolve ambiguity, truncate at stop codon.

    Returns the processed sequence (stop codon, if any, retained as its
    final byte). Raises InvalidAminoAcid on the first bad residue
    *before* the stop codon — characters after '*' are never examined,
    matching the reference's early return.
    """
    arr = UPPER_LUT[np.frombuffer(seq, dtype=np.uint8)] if seq else np.zeros(0, np.uint8)

    stops = np.flatnonzero(arr == ord("*"))
    if stops.size:
        arr = arr[: stops[0] + 1]

    valid = VALID_LUT[arr]
    if not valid.all():
        bad = int(np.flatnonzero(~valid)[0])
        raise InvalidAminoAcid(chr(int(arr[bad])), bad + 1, name)

    if policy == "first":
        arr = RESOLVE_FIRST_LUT[arr]
    elif policy == "random":
        rng = rng or np.random.default_rng()
        for code, choices in AMBIGUITY_CHOICES.items():
            idx = np.flatnonzero(arr == ord(code))
            if idx.size:
                picks = rng.integers(0, len(choices), size=idx.size)
                arr[idx] = np.frombuffer(choices.encode(), np.uint8)[picks]
    else:
        raise ValueError(f"unknown ambiguity policy: {policy}")
    return arr.tobytes()


def validate_resolve_batch(
    seqs: Sequence[bytes],
    names: Optional[Sequence[str]] = None,
    policy: str = "first",
    seed: Optional[int] = None,
) -> List[bytes]:
    """Fail-fast batch validation (whole file aborts on one bad AA)."""
    rng = np.random.default_rng(seed) if policy == "random" else None
    out = []
    for i, s in enumerate(seqs):
        out.append(
            validate_resolve(
                s, names[i] if names else None, policy=policy, rng=rng
            )
        )
    return out
