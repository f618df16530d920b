"""sourmash ``.sig.zip`` interop: reader and writer.

Counterpart of ``kmerseek_tpu/core/sigzip.py`` (copied). Format (as
sourmash writes it): a zip archive containing

* ``signatures/<md5>.sig.gz`` — gzipped JSON list with one object:
  ``{class: "sourmash_signature", email: "", hash_function:
  "0.murmur64", filename, name, license: "CC0", version: 0.4,
  signatures: [{num: 0, ksize: 3k, seed: 42, max_hash, mins,
  abundances, md5sum, molecule}]}``
* ``SOURMASH-MANIFEST.csv`` — ``# SOURMASH-MANIFEST-VERSION: 1.0``
  header then rows ``internal_location,md5,md5short,ksize,moltype,num,
  scaled,n_hashes,with_abundance,name,filename``; note the manifest
  ksize column is the *protein* ksize while the JSON carries 3k.

This is pure-format IO (the reference gets it from the sourmash/
branchwater libraries); it lets this package exchange signatures
with sourmash tooling and validate against committed fixtures.
"""

from __future__ import annotations

import csv
import gzip
import io
import json
import zipfile
from typing import List

import numpy as np

from .signature import Signature, minhash_ksize


def write_sig_zip(path: str, signatures: List[Signature]) -> str:
    """Write signatures as a sourmash-compatible .sig.zip."""
    manifest_rows = []
    used_names = set()
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED) as z:
        for sig in signatures:
            md5 = sig.md5sum
            # identical sketches (duplicate proteins) share one md5;
            # deduplicate internal names like sourmash ZipStorage does so
            # no signature is silently shadowed inside the archive
            internal = f"signatures/{md5}.sig.gz"
            bump = 0
            while internal in used_names:
                bump += 1
                internal = f"signatures/{md5}_{bump}.sig.gz"
            used_names.add(internal)
            payload = [
                {
                    "class": "sourmash_signature",
                    "email": "",
                    "hash_function": "0.murmur64",
                    "filename": sig.filename,
                    "name": sig.name,
                    "license": "CC0",
                    "signatures": [
                        {
                            "num": 0,
                            "ksize": minhash_ksize(sig.ksize),
                            "seed": 42,
                            "max_hash": sig.max_hash,
                            "mins": [int(x) for x in sig.mins],
                            "md5sum": md5,
                            "abundances": [int(a) for a in sig.abundances],
                            "molecule": sig.moltype,
                        }
                    ],
                    "version": 0.4,
                }
            ]
            # byte-fidelity with sourmash-written archives: compact JSON
            # separators (serde_json style), gzip mtime 0, and the zip
            # epoch (1980-01-01) member date — the whole archive is
            # deterministic and the decompressed payloads byte-match the
            # reference's committed *.sig.TRUE.zip fixtures
            blob = gzip.compress(
                json.dumps(payload, separators=(",", ":")).encode(), mtime=0
            )
            z.writestr(zipfile.ZipInfo(internal), blob)
            manifest_rows.append(
                [
                    internal,
                    md5,
                    sig.md5short,
                    str(sig.ksize),
                    sig.moltype,
                    "0",
                    str(sig.scaled),
                    str(sig.n_hashes),
                    "1",
                    sig.name,
                    sig.filename,
                ]
            )
        buf = io.StringIO()
        # \n line endings throughout (the Rust csv crate's default —
        # matches the committed sourmash fixtures byte-for-byte)
        buf.write("# SOURMASH-MANIFEST-VERSION: 1.0\n")
        w = csv.writer(buf, lineterminator="\n")
        w.writerow(
            [
                "internal_location",
                "md5",
                "md5short",
                "ksize",
                "moltype",
                "num",
                "scaled",
                "n_hashes",
                "with_abundance",
                "name",
                "filename",
            ]
        )
        for row in manifest_rows:
            w.writerow(row)
        z.writestr(zipfile.ZipInfo("SOURMASH-MANIFEST.csv"), buf.getvalue())
    return path


def read_sig_zip(path: str) -> List[Signature]:
    """Read a sourmash .sig.zip (ours or sourmash/branchwater-written)."""
    out: List[Signature] = []
    with zipfile.ZipFile(path) as z:
        names = [n for n in z.namelist() if n.startswith("signatures/")]
        for name in names:
            data = z.read(name)
            if name.endswith(".gz"):
                data = gzip.decompress(data)
            for obj in json.loads(data):
                for inner in obj.get("signatures", []):
                    mk = inner["ksize"]
                    moltype = inner.get("molecule", "protein")
                    if moltype not in ("protein", "dayhoff", "hp"):
                        # sourmash archives may also carry DNA sketches;
                        # the protein ksize×3 convention doesn't apply —
                        # skip them rather than mis-decode
                        from ..utils.logging import logger

                        logger.warning(
                            "skipping non-protein sketch (molecule=%s) "
                            "in %s", moltype, path,
                        )
                        continue
                    scaled = _scaled_from_max_hash(inner.get("max_hash", 0))
                    out.append(
                        Signature(
                            name=obj.get("name", ""),
                            mins=np.asarray(inner["mins"], dtype=np.uint64),
                            abundances=np.asarray(
                                inner.get("abundances")
                                if inner.get("abundances") is not None
                                else np.ones(len(inner["mins"]), np.int64),
                                dtype=np.int64,
                            ),
                            ksize=mk // 3,
                            scaled=scaled,
                            moltype=moltype,
                            filename=obj.get("filename", ""),
                        )
                    )
    return out


def _scaled_from_max_hash(max_hash: int) -> int:
    if max_hash in (0, 2**64 - 1):
        return 1
    # invert sourmash's f64 division
    return max(1, round(float(2**64) / float(max_hash)))
