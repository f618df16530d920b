"""Two trees of the port's CUDA kernels timed in one process on one GPU.

    git archive <commit> | tar -x -C _archive/parent     # the tree to compare with
    python3 bench_torch_kernels_ab.py --parent _archive/parent [--out DIR]

Two runs may land on two cards, and run-to-run spread is large, so a
kernel edit is judged inside one process: the wrappers of ``--parent``'s
``kmerseek_tpu_torch`` and of this tree's are loaded in turn (parent,
this, this, parent), each builds its own ``csrc/`` into its own
``_build/``, and each is timed on the same inputs with
``chip_smoke.device_time_ms`` (device time per call from a replayed CUDA
graph) and ``chip_smoke.host_clock_ms`` (host clock per wrapper call),
at chip_smoke's timed shapes. Prints one JSON line per turn and writes
them all to ``DIR/kernels_ab.json``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

import numpy as np
import torch

import chip_smoke

HERE = os.path.dirname(os.path.abspath(__file__))


def load_wrappers(tree: str) -> dict:
    """The three kernel wrappers of ``tree``'s ``kmerseek_tpu_torch``."""
    for name in [m for m in sys.modules if m.split(".")[0] == "kmerseek_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, tree)
    try:
        sketch_cuda = importlib.import_module("kmerseek_tpu_torch.ops.sketch_cuda")
        sort_cuda = importlib.import_module("kmerseek_tpu_torch.ops.sort_cuda")
    finally:
        sys.path.remove(tree)
    assert os.path.abspath(sketch_cuda.__file__).startswith(os.path.abspath(tree) + os.sep)
    return {
        "masked_window_keys": sketch_cuda.masked_window_keys,
        "window_hashes": sketch_cuda.window_hashes,
        "bitonic_sort_rows": sort_cuda.bitonic_sort_rows,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="root of the tree to compare with")
    ap.add_argument("--out", default="profile_out")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: this comparison needs a GPU")
        return 2
    dev = torch.device("cuda")
    card = chip_smoke.nvidia_smi("name,power.limit")
    chip_smoke.log(f"card: {card}")
    rng = np.random.default_rng(args.seed)

    B, L = 1024, 1024
    kw = dict(k=24, scaled=5, moltype="hp")
    # every row at full length, where chip_smoke's bound (all B*W windows)
    # describes the work; and lengths L/2..L, as the main path's batches are
    full, ragged = [], []
    for _ in range(8):
        seqs = torch.from_numpy(chip_smoke.AA[rng.integers(0, 20, size=(B, L))]).to(dev)
        lens = torch.from_numpy(rng.integers(L // 2, L + 1, size=B).astype(np.int32)).to(dev)
        full.append((seqs, torch.full_like(lens, L)))
        ragged.append((seqs, lens))
    sort_inputs = {
        shape: [(chip_smoke.sort_keys(rng, *shape, dev),) for _ in range(8)]
        for shape in ((1024, 1024), (128, 8192), (2, 65536))
    }

    turns = []
    for label, tree in (("parent", args.parent), ("this", HERE), ("this", HERE), ("parent", args.parent)):
        fns = load_wrappers(os.path.abspath(tree))
        row = {"tree": label, "card": card}
        for name in ("masked_window_keys", "window_hashes"):
            call = lambda s, n, fn=fns[name]: fn(s, n, **kw)  # noqa: E731
            row[name] = {
                "shape": [B, L], "ms": chip_smoke.device_time_ms(call, full),
                "ragged_ms": chip_smoke.device_time_ms(call, ragged),
                "host_ms": chip_smoke.host_clock_ms(call, full),
            }
        for shape, inputs in sort_inputs.items():
            row[f"bitonic_sort_rows {shape[0]}x{shape[1]}"] = {
                "ms": chip_smoke.device_time_ms(fns["bitonic_sort_rows"], inputs),
                "host_ms": chip_smoke.host_clock_ms(fns["bitonic_sort_rows"], inputs),
            }
        turns.append(row)
        print(json.dumps(row), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "kernels_ab.json"), "w") as f:
        json.dump(turns, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
