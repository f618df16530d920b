"""Where the time goes on the port's main path and its k-mer path, on
one GPU.

    python3 profile_torch_main_path.py [--seed N] [--out DIR]

Builds chip_smoke.py's seeded proteome (20,000 targets, 1,024 queries),
then runs in this process, each under ``cProfile`` (host time by
function) and ``torch.profiler`` (device time by kernel):

* ``kmerseek index`` and ``kmerseek search`` (the main path);
* ``kmerseek index --extract-kmers --force`` at the defaults, then
  ``index --extract-kmers`` and ``search --extract-kmers
  --stitch-per-query`` in chip_smoke's stitching alphabet (path A);
* ``do_multisearch`` on the two ``.sig.zip`` files and one
  ``_device_pair_stats`` block of the dense inverted engine (path C);
* ``parallel/`` in this one process (path D): ``build_sharded_index`` as
  the only rank (the whole FASTA, every exchange a no-op), both sharded
  searches against it, and one ``sharded_inverted_search`` block and one
  ``sharded_sparse_search`` on a mesh of four shards.

Prints the wall time of each command, the device's busy share (summed
device kernel time over wall time), the top device kernels and the top
host functions by cumulative time; the full tables go to
``DIR/profile_*.txt``.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke


# the port's hand-written kernels, as the profiler names them
OWN_KERNELS = ("masked_sketch_kernel", "window_hashes_kernel", "sort_warp_kernel",
               "sort_tile_kernel", "sort_global_kernel")


def _device_us(prof) -> tuple:
    """(summed device time in us, [(name, us, calls)] by kernel): the
    device-side events only — kernels, memcpy, memset — so that an
    operator's time is not counted again beside its kernels; CUDA's lazy
    module-loading records are left out."""
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or "Loading" in e.key:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((e.key, us, e.count))
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows


def run(label: str, args, out_dir: str) -> None:
    """Profile one command: ``args`` is the kmerseek command line, or a
    function to call."""
    call = args if callable(args) else (lambda: chip_smoke.kmerseek_quiet_stderr(*args))
    torch.cuda.synchronize()
    pr = cProfile.Profile()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pr.enable()
        call()
        torch.cuda.synchronize()
        pr.disable()
        wall = time.perf_counter() - t0
    dev_us, rows = _device_us(prof)
    chip_smoke.log(
        f"{label}: wall {wall:.3f} s under both profilers; device busy "
        f"{dev_us / 1e3:.3f} ms = {dev_us / 1e4 / wall:.4f}% of wall"
    )
    sketch = [r for r in rows if any(n in r[0] for n in OWN_KERNELS)]
    for name, us, n in rows[:8] + [r for r in sketch if r not in rows[:8]]:
        chip_smoke.log(f"  device {us / 1e3:9.3f} ms  {n:5d} calls  {name[:90]}")
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("cumulative").print_stats(40)
    text = buf.getvalue()
    with open(os.path.join(out_dir, f"profile_{label}.txt"), "w") as f:
        f.write(text)
        f.write("\n\ndevice kernels (ms, calls, name)\n")
        for name, us, n in rows:
            f.write(f"{us / 1e3:.3f}\t{n}\t{name}\n")
    st = pstats.Stats(pr)
    top = sorted(st.stats.items(), key=lambda kv: -kv[1][3])  # cumulative time
    shown = 0
    for (fn, line, name), (_cc, _nc, _tt, ct, _callers) in top:
        if "kmerseek_tpu_torch" not in fn or shown >= 12:
            continue
        shown += 1
        rel = fn[fn.index("kmerseek_tpu_torch"):]
        chip_smoke.log(f"  host {ct:8.3f} s cumulative  {rel}:{line} {name}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: this profile needs a GPU")
        return 2
    os.makedirs(args.out, exist_ok=True)
    chip_smoke.log(f"card: {chip_smoke.nvidia_smi('name,power.limit')}")
    chip_smoke.cuda_build.build_all(chip_smoke.SOURCES)
    rng = np.random.default_rng(args.seed)
    targets, _lens, queries, qnames, _planted = chip_smoke.make_corpus(rng)
    with tempfile.TemporaryDirectory(prefix="kmerseek-profile-") as d:
        tfa, qfa = os.path.join(d, "target.fa"), os.path.join(d, "query.fa")
        chip_smoke.write_fasta(tfa, [f"t{i}" for i in range(len(targets))], targets)
        chip_smoke.write_fasta(qfa, qnames, queries)
        run("index", ["index", tfa], args.out)
        run("search", ["search", qfa, tfa, "--output", os.path.join(d, "out.csv")], args.out)
        m = ("--moltype", chip_smoke.PATH_A_MOLTYPE)
        run("index_kmers", ["index", "--extract-kmers", "--force", tfa], args.out)
        run(f"index_kmers_{m[1]}", ["index", "--extract-kmers", *m, tfa], args.out)
        run(
            "search_kmers",
            ["search", "--extract-kmers", "--stitch-per-query", *m, qfa, tfa,
             "--output", os.path.join(d, "stitched.csv")],
            args.out,
        )
        from kmerseek_tpu_torch.core import search as search_mod
        from kmerseek_tpu_torch.core.index import ProteomeIndex

        qsig, tsig = (f"{fa}.hp.k24.scaled5.sig.zip" for fa in (qfa, tfa))
        run(
            "multisearch",
            lambda: search_mod.do_multisearch(qsig, tsig, os.path.join(d, "multi.csv")),
            args.out,
        )
        query = search_mod._as_index(qsig)
        target = ProteomeIndex.load(f"{tsig}.ksx")
        search_mod._device_pair_stats(query, target)  # postings uploaded, allocator warm
        run("dense_pair_stats", lambda: search_mod._device_pair_stats(query, target), args.out)

        from kmerseek_tpu_torch.parallel import dist as pdist
        from kmerseek_tpu_torch.parallel import sharded

        box = {}
        run("build_sharded_index", lambda: box.update(sh=sharded.build_sharded_index(tfa)), args.out)
        run("sharded_manysearch", lambda: sharded.sharded_manysearch_columns(query, box["sh"]), args.out)
        run("sharded_multisearch", lambda: sharded.sharded_multisearch_columns(query, box["sh"]), args.out)
        mesh = pdist.make_mesh(4)
        q_keys, q_valid = query.dense_device_keys()
        inv = target.inverted
        pdist.sharded_inverted_search(mesh, inv, q_keys, q_valid)  # slices uploaded, allocator warm
        run("sharded_inverted_search", lambda: pdist.sharded_inverted_search(mesh, inv, q_keys, q_valid), args.out)
        run("sharded_sparse_search", lambda: pdist.sharded_sparse_search(mesh, inv, q_keys, q_valid), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
