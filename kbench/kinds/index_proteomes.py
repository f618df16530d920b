"""Index traffic: one proteome after another, each through the command
that the configuration's ``index_command`` names.

* ``kmerseek index``: ``KmerseekIndex(fasta, force=True)`` then ``.sig``
  and ``.ksx``, which write the ``.sig.zip``, the ``.manysketch.csv``,
  the ``.siglist`` and the ``.ksx`` beside the FASTA. ``.index`` is read
  first (the build ``.sig`` would start lazily), so the build and the
  ``.sig.zip`` write have spans of their own.
* ``kmerseek-rust index``: ``ProteomeIndex.build(fasta, progress_interval
  =10000)`` then ``save`` to the default ``.kmerseek.ksx`` name.

The Python CLI's group raises glibc's malloc thresholds
(``utils.hostmem.tune_host_allocator``) before any command; the Rust
CLI's port does not, so neither does its cell.

Set-up writes a pool of proteomes (the traffic's ``proteome`` shape) as
FASTA. A request links its proteome into ``current/`` and indexes it
there, over the products of the request before; a request in the
check's sample moves ``current/`` aside after it ends. The check reads
those products and the last request's with ``kbench``'s own readers
against the plain reference's sketches of the same FASTA.
"""

from __future__ import annotations

import math
import os

import numpy as np

from kbench import gen
from kbench.reference import products, sketch

LIMITS = {"sigs_off": 0, "postings_off": 0, "meta_off": 0, "sigzip_off": 0}
FASTA = "proteome.fa"


def _products(run, fasta: str) -> dict:
    cfg = run.config
    k, s, m = cfg["ksize"], cfg["scaled"], cfg["moltype"]
    if cfg["index_command"] == "kmerseek index":
        sig = f"{fasta}.{m}.k{k}.scaled{s}.sig.zip"
        return {"sig": sig, "ksx": f"{sig}.ksx"}
    return {"ksx": f"{fasta}.{m}.k{k}.scaled{s}.kmerseek.ksx"}


def setup(run) -> None:
    from kmerseek_tpu_torch.core.index import IndexConfig

    cfg, tr = run.config, run.traffic
    if cfg["index_command"] not in ("kmerseek index", "kmerseek-rust index"):
        raise ValueError(f"unknown index_command {cfg['index_command']!r}")
    if cfg["index_command"] == "kmerseek index":
        from kmerseek_tpu_torch.utils.hostmem import tune_host_allocator

        tune_host_allocator()  # as `kmerseek index` does first (cli.py's group)
    run.index_config = IndexConfig(cfg["ksize"], cfg["scaled"], cfg["moltype"])
    os.makedirs(os.path.join(run.workdir, "pool"))
    os.makedirs(os.path.join(run.workdir, "kept"))
    run.pool = 2 + math.ceil(tr["pool_proteomes_per_s"] * run.seconds)
    rng = gen.rng_for(run.seed, 3)
    run.residues, run.windows = [], []
    k = cfg["ksize"]
    for j in range(run.pool):
        p = gen.proteome(tr["proteome"], rng, f"p{j}")
        gen.write_fasta(os.path.join(run.workdir, "pool", f"p{j}.fa"), p)
        run.residues.append(int(p.offsets[-1]))
        run.windows.append(int(np.maximum(p.lengths - k + 1, 0).sum()))
    run.indexed = {}


def request(run, i: int) -> int:
    from kmerseek_tpu_torch.core.entity import KmerseekIndex
    from kmerseek_tpu_torch.core.index import ProteomeIndex

    item = i + 2 if i < 0 else 2 + i % (run.pool - 2)
    cur = os.path.join(run.workdir, "current")
    os.makedirs(cur, exist_ok=True)
    fasta = os.path.join(cur, FASTA)
    tmp = fasta + ".link"
    os.link(os.path.join(run.workdir, "pool", f"p{item}.fa"), tmp)
    os.replace(tmp, fasta)
    cfg = run.config
    if cfg["index_command"] == "kmerseek index":
        entity = KmerseekIndex(fasta, moltype=cfg["moltype"], ksize=cfg["ksize"],
                               scaled=cfg["scaled"], force=True, device=run.device)
        with run.span("sketch"):
            entity.index
        with run.span("sigzip"):
            entity.sig
        with run.span("ksx"):
            entity.ksx
    else:
        with run.span("sketch"):
            idx = ProteomeIndex.build(fasta, run.index_config, progress_interval=10000,
                                      device=run.device)
        with run.span("ksx"):
            idx.save(_products(run, fasta)["ksx"])
    where = cur
    if run.checked(i):
        where = os.path.join(run.workdir, "kept", f"r{i}")
        os.replace(cur, where)
    run.indexed[i] = (item, where)
    run.work[i] = {"residues": run.residues[item], "windows": run.windows[item]}
    return run.residues[item]


def end_to_end(run) -> dict:
    return {"index_residues_per_s": sum(u for *_, u in run.records) / run.window_s}


def check(run) -> dict:
    cfg = run.config
    k, scaled, moltype = cfg["ksize"], cfg["scaled"], cfg["moltype"]
    last = run.records[-1][0]
    due = sorted(i for i in run.indexed if i >= 0 and (run.checked(i) or i == last))
    out = {name: 0 for name in LIMITS}
    if cfg["index_command"] != "kmerseek index":
        del out["sigzip_off"]
    for i in due:
        item, where = run.indexed[i]
        ref = sketch.sketch_fasta(os.path.join(run.workdir, "pool", f"p{item}.fa"), k, scaled, moltype)
        # the program was handed the path it indexed under current/
        fasta = os.path.join(run.workdir, "current", FASTA)
        got = _products(run, os.path.join(where, FASTA))
        try:
            for name, v in products.compare_ksx(got["ksx"], ref, k, scaled, moltype, fasta).items():
                out[name] += v
        except (OSError, ValueError, KeyError):
            out["sigs_off"] += len(ref.names) or 1
        if "sig" in got:
            try:
                out["sigzip_off"] += products.compare_sig_zip(got["sig"], ref, k, scaled, moltype, fasta)["sigzip_off"]
            except (OSError, ValueError, KeyError):
                out["sigzip_off"] += len(ref.names) or 1
    run.checked_requests = due
    return {name: (v, LIMITS[name]) for name, v in out.items()}
