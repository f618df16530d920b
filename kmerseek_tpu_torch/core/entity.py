"""Lazy file-product orchestration: sketch and index artifacts
(counterpart of ``kmerseek_tpu/core/entity.py``).

Artifacts are cached on disk under kmerseek's filename conventions and
reused unless ``force``:

* ``{fasta}.{moltype}.k{k}.scaled{s}.sig.zip``
* ``{sig}.ksx`` — the columnar index directory
"""

from __future__ import annotations

import os
from typing import Optional

from ..utils.logging import logger
from .index import IndexConfig, ProteomeIndex


def make_sigfile(fasta: str, moltype: str, ksize: int, scaled: int) -> str:
    return f"{fasta}.{moltype}.k{ksize}.scaled{scaled}.sig.zip"


def make_index_dirname(sig: str) -> str:
    return f"{sig}.ksx"


def make_manysketch_csv(fasta: str) -> str:
    """``{fasta}.manysketch.csv`` side artifact of ``kmerseek index``."""
    csv = f"{fasta}.manysketch.csv"
    basename = os.path.basename(fasta)
    with open(csv, "w") as f:
        f.write("name,genome_filename,protein_filename\n")
        f.write(f"{basename},,{fasta}\n")
    return csv


def make_siglist_file(sig: str) -> str:
    """``{sig}.siglist`` (one path, no trailing newline)."""
    siglist = f"{sig}.siglist"
    with open(siglist, "w") as f:
        f.write(f"{sig}")
    return siglist


class KmerseekEntity:
    """Base: lazily produces the .sig.zip and the in-memory index."""

    def __init__(
        self,
        fasta: str,
        moltype: str = "hp",
        ksize: int = 24,
        scaled: int = 5,
        force: bool = False,
        device=None,
    ):
        self.fasta = fasta
        self.config = IndexConfig(ksize=ksize, scaled=scaled, moltype=moltype)
        self.force = force
        self.device = device
        self._index: Optional[ProteomeIndex] = None
        self._sig: Optional[str] = None

    def _sigfile(self) -> str:
        c = self.config
        return make_sigfile(self.fasta, c.moltype, c.ksize, c.scaled)

    @property
    def index(self) -> ProteomeIndex:
        """The in-memory ProteomeIndex (built on the device or loaded)."""
        if self._index is None:
            idx_dir = make_index_dirname(self._sigfile())
            if not self.force and os.path.isdir(idx_dir):
                logger.info("Found index %s, loading (re-make with '--force')", idx_dir)
                self._index = ProteomeIndex.load(idx_dir, device=self.device)
            else:
                self._index = ProteomeIndex.build(
                    self.fasta, self.config, device=self.device
                )
        return self._index

    @property
    def sig(self) -> str:
        """Path to the .sig.zip product."""
        if self._sig is None:
            sigfile = self._sigfile()
            if self.force or not os.path.exists(sigfile):
                if os.path.exists(sigfile):
                    logger.info(
                        "Found %s file, but re-making with '--force'", sigfile
                    )
                make_manysketch_csv(self.fasta)
                self.index.to_sig_zip(sigfile)
            else:
                logger.info(
                    "Found signature file %s, skipping! Re-make with '--force'",
                    sigfile,
                )
            self._sig = sigfile
        return self._sig


class KmerseekQuery(KmerseekEntity):
    """Query-side entity."""


class KmerseekIndex(KmerseekEntity):
    """Index-side entity; persists the columnar index next to the sig."""

    @property
    def ksx(self) -> str:
        idx_dir = make_index_dirname(self.sig)
        if self.force or not os.path.isdir(idx_dir):
            make_siglist_file(self.sig)
            self.index.save(idx_dir)
        return idx_dir
