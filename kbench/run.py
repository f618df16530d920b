"""Run one benchmark cell of the PyTorch/CUDA port and print one line.

    python3 kbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``kbench/``
and the port, on a machine with the CUDA devices the cell asks for. The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
also ``breakdown``, and ``checks``: each number compared with its
limit, also printed as the last lines of standard error). Data files go
to a directory under ``TMPDIR`` that is removed at the end; the port
builds its kernels into ``kmerseek_tpu_torch/_build/`` in the checkout.
Exits non-zero, with no result, without the devices, or when JAX or the
JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# run as a script: the checkout's root, not kbench/, heads the path
if sys.path and os.path.abspath(sys.path[0]) == os.path.join(ROOT, "kbench"):
    sys.path[0] = ROOT


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from kbench import harness

    spec = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    chips = {w["name"]: w for w in spec["workloads"]}.get(args.workload, {}).get("chips", 1)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"kbench: the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    workdir = tempfile.mkdtemp(prefix="kbench-", dir=os.path.abspath(tempfile.gettempdir()))
    try:
        run = harness.Run(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                          "cuda", workdir)
        run.t_start = T_START
        out = harness.run_cell(run)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    found = harness.forbidden_modules()
    if found:
        print(f"kbench: the run loaded {found}; nothing it runs may import JAX or the JAX package",
              file=sys.stderr)
        return 3
    _io_report()
    harness.print_checks(out["checks"])
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def _io_report() -> None:
    """Bytes this process read and wrote (``/proc/self/io``)."""
    try:
        with open("/proc/self/io") as f:
            io = dict(line.split(": ") for line in f.read().split("\n") if ": " in line)
        print("io: " + ", ".join(f"{k} {int(v)}" for k, v in io.items()), file=sys.stderr)
    except OSError:
        pass


if __name__ == "__main__":
    sys.exit(main())
