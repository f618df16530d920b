"""Search traffic: blocks of queries against one loaded target index, as
``kmerseek search`` serves them once it has the target.

Set-up writes the target proteome (the configuration's ``target``) and
the pool of query blocks as FASTA, builds the target's ``.ksx`` with the
program, and loads it back as the CLI would find it on disk. A request
is one block: sketch the block (``ProteomeIndex.build``), ``manysearch``
against the target (with the device cross-check inside it), and
``write_search_csv``. The block's own ``.sig.zip`` is not written.

The check reads the CSV of a seeded sample of the window's blocks and of
its last block, row by row and column by column, against the plain
reference run over the same FASTA files.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np

from kbench import gen
from kbench.reference import products, search, sketch

LIMITS = {"rows_off": 0, "exact_cells_off": 0, "float_rel_err": 1e-9}


def _block_path(run, item: int) -> str:
    return os.path.join(run.workdir, "blocks", f"b{item}.fa")


def setup(run) -> None:
    from kmerseek_tpu_torch.core.index import IndexConfig, ProteomeIndex
    from kmerseek_tpu_torch.utils.hostmem import tune_host_allocator

    tune_host_allocator()  # as `kmerseek search` does first (cli.py's group)
    cfg, tr = run.config, run.traffic
    target = gen.proteome(cfg["target"], gen.rng_for(run.seed, 1), "target")
    run.target_fasta = gen.write_fasta(os.path.join(run.workdir, "target.fa"), target)
    os.makedirs(os.path.join(run.workdir, "blocks"))
    os.makedirs(os.path.join(run.workdir, "csv"))
    run.pool = 2 + math.ceil(tr["pool_blocks_per_s"] * run.seconds)
    blocks = gen.query_blocks(target, tr["block"], gen.rng_for(run.seed, 2), run.pool)
    for b, block in enumerate(blocks):
        gen.write_fasta(_block_path(run, b), block)
    # every block has the same lengths: the sketch work of one request
    k = cfg["ksize"]
    run.block_work = {"residues": int(block.offsets[-1]),
                      "windows": int(np.maximum(block.lengths - k + 1, 0).sum())}
    del target
    run.index_config = IndexConfig(cfg["ksize"], cfg["scaled"], cfg["moltype"])
    ksx = os.path.join(run.workdir, "target.ksx")
    with run.span("target_build"):
        ProteomeIndex.build(run.target_fasta, run.index_config, device=run.device).save(ksx)
    with run.span("target_load"):
        run.state["target"] = ProteomeIndex.load(ksx, device=run.device)
    run.csv = {}


def request(run, i: int) -> int:
    from kmerseek_tpu_torch.core.index import ProteomeIndex
    from kmerseek_tpu_torch.core.search import MANYSEARCH_COLUMNS, manysearch, write_search_csv

    item = i + 2 if i < 0 else 2 + i % (run.pool - 2)
    name = f"b{item}_r{i}.csv" if run.checked(i) else "current.csv"
    out = os.path.join(run.workdir, "csv", name)
    with run.span("query_sketch"):
        query = ProteomeIndex.build(_block_path(run, item), run.index_config, device=run.device)
    with run.span("join"):
        rows = manysearch(query, run.state["target"])
    with run.span("csv"):
        write_search_csv(rows, MANYSEARCH_COLUMNS, out)
    run.csv[i] = (item, out)
    run.work[i] = run.block_work
    return run.traffic["block"]["size"]


def end_to_end(run) -> dict:
    lat = [t1 - t0 for _, t0, t1, _ in run.records]
    return {
        "search_queries_per_s": sum(u for *_, u in run.records) / run.window_s,
        "search_block_p95_ms": float(np.percentile(lat, 95)) * 1e3,
    }


def check(run) -> dict:
    cfg = run.config
    k, scaled, moltype = cfg["ksize"], cfg["scaled"], cfg["moltype"]
    last = run.records[-1][0]
    due = sorted(i for i in run.csv if i >= 0 and (run.checked(i) or i == last))
    t = sketch.sketch_fasta(run.target_fasta, k, scaled, moltype)
    ts = search.TargetStats(t, sketch.postings(t), k)
    out = {"rows_off": 0, "exact_cells_off": 0, "float_rel_err": 0.0}
    rows = 0
    for i in due:
        item, path = run.csv[i]
        q = sketch.sketch_fasta(_block_path(run, item), k, scaled, moltype)
        want = search.manysearch(q, ts, scaled, moltype)
        rows += len(want)
        got = products.compare_csv(path, want) if os.path.exists(path) else {
            "rows_off": len(want) + 1, "exact_cells_off": 0, "float_rel_err": math.inf}
        out["rows_off"] += got["rows_off"]
        out["exact_cells_off"] += got["exact_cells_off"]
        out["float_rel_err"] = max(out["float_rel_err"], got["float_rel_err"])
    run.checked_requests = due
    print(f"checked {len(due)} blocks, {rows} rows", file=sys.stderr)
    return {name: (v, LIMITS[name]) for name, v in out.items()}
