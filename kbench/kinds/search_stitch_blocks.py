"""Stitched search traffic: blocks of queries against one loaded target
index and its k-mer sidecar, as ``kmerseek search --extract-kmers``
serves them once it has the target.

Set-up writes the target proteome (the configuration's ``target``) and
the pool of query blocks as FASTA, builds the target's ``.ksx`` with its
sequences, loads it back as the CLI would find it on disk, and writes
the target's k-mer sidecar (as ``kmerseek index --extract-kmers`` does;
harness span ``target_kmers``). A request is one block: sketch it with
its sequences (``ProteomeIndex.build``), ``manysearch`` against the
target, write the block's sidecar (``write_kmer_table_for_index``) and
stitch (``write_stitched``, grouped as the configuration's
``stitch_per_query`` says), the CSV and the report to files. The block's
own ``.sig.zip`` is not written.

The check reads the sidecar, the stitched CSV and the report of a
seeded sample of the window's blocks and of its last block against the
plain reference (``kbench/reference/stitch.py``) run over the same FASTA
files.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np

from kbench import gen
from kbench.reference import stitch

LIMITS = {"kmers_rows_off": 0, "kmers_cells_off": 0, "stitched_rows_off": 0, "stitched_cells_off": 0,
          "report_off": 0}
PRODUCTS = ("kmers.pq", "csv", "report.txt")


def _block_path(run, item: int) -> str:
    return os.path.join(run.workdir, "blocks", f"b{item}.fa")


def setup(run) -> None:
    from kmerseek_tpu_torch.core.index import IndexConfig, ProteomeIndex
    from kmerseek_tpu_torch.core.kmers import write_kmer_table_for_index
    from kmerseek_tpu_torch.core.stitch import write_stitched  # noqa: F401  (fail here, in seconds, without it)
    from kmerseek_tpu_torch.utils.hostmem import tune_host_allocator

    tune_host_allocator()  # as `kmerseek search` does first (cli.py's group)
    cfg, tr = run.config, run.traffic
    target = gen.proteome(cfg["target"], gen.rng_for(run.seed, 1), "target")
    run.target_fasta = gen.write_fasta(os.path.join(run.workdir, "target.fa"), target)
    os.makedirs(os.path.join(run.workdir, "blocks"))
    os.makedirs(os.path.join(run.workdir, "out"))
    run.pool = 2 + math.ceil(tr["pool_blocks_per_s"] * run.seconds)
    blocks = gen.query_blocks(target, tr["block"], gen.rng_for(run.seed, 2), run.pool)
    for b, block in enumerate(blocks):
        gen.write_fasta(_block_path(run, b), block)
    # every block has the same lengths: the hash work of one request
    k = cfg["ksize"]
    run.block_work = {"residues": int(block.offsets[-1]),
                      "windows": int(np.maximum(block.lengths - k + 1, 0).sum())}
    del target
    run.index_config = IndexConfig(cfg["ksize"], cfg["scaled"], cfg["moltype"])
    ksx = os.path.join(run.workdir, "target.ksx")
    with run.span("target_build"):
        ProteomeIndex.build(run.target_fasta, run.index_config, store_raw_sequences=True,
                            device=run.device).save(ksx)
    with run.span("target_load"):
        run.state["target"] = ProteomeIndex.load(ksx, device=run.device)
    run.target_kmers = os.path.join(run.workdir, "target.kmers.pq")
    with run.span("target_kmers"):
        write_kmer_table_for_index(run.state["target"], run.target_kmers)
    run.out = {}


def request(run, i: int) -> int:
    from kmerseek_tpu_torch.core.index import ProteomeIndex
    from kmerseek_tpu_torch.core.kmers import write_kmer_table_for_index
    from kmerseek_tpu_torch.core.search import manysearch
    from kmerseek_tpu_torch.core.stitch import write_stitched

    item = i + 2 if i < 0 else 2 + i % (run.pool - 2)
    tag = f"b{item}_r{i}" if run.checked(i) else "current"
    paths = {p: os.path.join(run.workdir, "out", f"{tag}.{p}") for p in PRODUCTS}
    with run.span("query_sketch"):
        query = ProteomeIndex.build(_block_path(run, item), run.index_config, store_raw_sequences=True,
                                    device=run.device)
    with run.span("join"):
        rows = manysearch(query, run.state["target"])
    with run.span("kmers"):
        write_kmer_table_for_index(query, paths["kmers.pq"])
    with run.span("stitch"):
        write_stitched(rows, paths["kmers.pq"], run.target_kmers, paths["csv"], paths["report.txt"],
                       group_by_pair=run.config["stitch_per_query"])
    run.out[i] = (item, paths)
    run.work[i] = run.block_work
    return run.traffic["block"]["size"]


def end_to_end(run) -> dict:
    # the p95 of ~30 blocks a window is not listed for the cell (PERF.md
    # section 2); it stays here so that an entry alone can list it later
    lat = [t1 - t0 for _, t0, t1, _ in run.records]
    return {
        "search_queries_per_s": sum(u for *_, u in run.records) / run.window_s,
        "search_block_p95_ms": float(np.percentile(lat, 95)) * 1e3,
    }


def _compare_block(fasta: str, paths: dict, target: stitch.Windows, cfg: dict) -> tuple:
    """The check numbers of one block, and how many rows it stitched."""
    k = cfg["ksize"]
    q = stitch.kept_windows(fasta, k, cfg["scaled"], cfg["moltype"])
    out = dict.fromkeys(LIMITS, 0)
    if os.path.exists(paths["kmers.pq"]):
        out.update(stitch.compare_sidecar(paths["kmers.pq"], stitch.sidecar_columns(q, k, os.path.abspath(fasta))))
    else:
        out["kmers_rows_off"] = len(q.sid) + 1
    try:
        rows, report = stitch.stitch(q, target, k, cfg["stitch_per_query"])
    except AssertionError:  # kmerseek's rule trips on this block: no output is right
        out["stitched_rows_off"] += 1
        return out, 0
    if os.path.exists(paths["csv"]):
        out.update(stitch.compare_stitched(paths["csv"], rows))
    else:
        out["stitched_rows_off"] = len(rows) + 1
    if os.path.exists(paths["report.txt"]):
        out.update(stitch.compare_report(paths["report.txt"], report))
    else:
        out["report_off"] = len(rows) + 1
    return out, len(rows)


def check(run) -> dict:
    cfg = run.config
    last = run.records[-1][0]
    due = sorted(i for i in run.out if i >= 0 and (run.checked(i) or i == last))
    target = stitch.kept_windows(run.target_fasta, cfg["ksize"], cfg["scaled"], cfg["moltype"])
    out = dict.fromkeys(LIMITS, 0)
    rows = 0
    for i in due:
        item, paths = run.out[i]
        got, n = _compare_block(_block_path(run, item), paths, target, cfg)
        rows += n
        for name, v in got.items():
            out[name] += v
    run.checked_requests = due
    print(f"checked {len(due)} blocks, {rows} stitched rows", file=sys.stderr)
    return {name: (v, LIMITS[name]) for name, v in out.items()}
