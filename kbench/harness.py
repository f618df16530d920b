"""The benchmark's harness: finds a cell's files by the names in
``BENCHMARK.json``, sets it up, warms it up, runs the measured window as
a closed loop with one client, checks what the window produced against
the plain reference, and builds the one result line.

Files found by name (a later cell adds files and entries, and edits
none):

* configuration ``kbench/configs/<config>.json`` (the ``file`` of its
  ``configs`` entry);
* traffic mix ``kbench/traffic/<traffic>.json``, whose ``kind`` names
  the request code ``kbench/kinds/<kind>.py``;
* per-layer metric ``kbench/metrics/<name>.py``, whose ``read(run)``
  returns the number or None when the run holds nothing to read; where
  that file is absent, ``kbench/metrics/<stem>.py`` for the name's part
  before its first dot, one reader for each split of one quantity
  (``device_idle_pct.index``, ``device_idle_pct.search``).

A kind module has ``setup(run)``, ``request(run, i) -> units``,
``end_to_end(run) -> {metric: value}``, ``check(run) -> {number: (value,
limit)}``; the program's state it keeps in ``run.state``, which is
dropped before the check.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import sys
import time
import traceback
from typing import Dict, Optional

from .gen import rng_for

KBENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(KBENCH)
# top-level module names that must never be loaded (the port is compared
# with the JAX package only in CPU tests; its name begins with the JAX
# package's, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "kmerseek_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    name = "kbench_" + os.path.relpath(path, KBENCH).replace("/", "_").replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def merge(base: dict, over: Optional[dict]) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def metric_reader(root: str, name: str):
    """The reader of per-layer metric ``name`` (see the module's list)."""
    path = os.path.join(root, "kbench", "metrics", f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(root, "kbench", "metrics", f"{name.split('.')[0]}.py")
    return load_module(path)


def _listed(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


class Run:
    """One run of one cell: its files, its spans and its requests."""

    def __init__(self, spec: dict, workload: str, seed: int, seconds: float, trace: bool,
                 device: str, workdir: str, overrides: Optional[dict] = None, root: str = ROOT):
        self.t_start = time.perf_counter()
        self.spec, self.root = spec, root
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
        self.cell = cells[workload]
        entry = {c["name"]: c for c in spec["configs"]}[self.cell["config"]]
        overrides = overrides or {}
        self.config = merge(load_json(os.path.join(root, entry["file"])), overrides.get("config"))
        self.traffic = merge(load_json(os.path.join(root, "kbench", "traffic", f"{self.cell['traffic']}.json")),
                             overrides.get("traffic"))
        self.kind = load_module(os.path.join(root, "kbench", "kinds", f"{self.traffic['kind']}.py"))
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.workdir = device, workdir
        self.spans = []  # (name, request, t0, t1)
        self.records = []  # (request, t0, t1, units)
        self.work: Dict[int, dict] = {}
        self.state: dict = {}
        self.req = None
        self.failed = 0
        self.summary = None
        self.window_start = None
        self._draw = rng_for(seed, 7).random(1 << 16)

    @contextlib.contextmanager
    def span(self, name: str):
        """Host-clock span around a call into one layer; in a traced run
        also a ``record_function`` range the device trace can place."""
        rf = contextlib.nullcontext()
        if self.trace:
            from torch.profiler import record_function

            rf = record_function(f"kbench/{name}")
        t0 = time.perf_counter()
        with rf:
            yield
        self.spans.append((name, self.req, t0, time.perf_counter()))

    def checked(self, i: int) -> bool:
        """Whether window request ``i`` is in the sample the check reads,
        drawn from the seed (the last request is always read too)."""
        return i >= 0 and self._draw[i % len(self._draw)] < 1.0 / self.traffic["check_every"]

    def span_s(self, name: str) -> float:
        return sum(t1 - t0 for n, r, t0, t1 in self.spans if n == name and r is not None and r >= 0)

    @property
    def window_s(self) -> float:
        """From the window's start to the end of its last request."""
        return self.records[-1][2] - self.window_start

    def sync(self) -> None:
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()


def _request(run: Run, i: int) -> None:
    run.req = i
    with run.span("request") if run.trace else contextlib.nullcontext():
        t0 = time.perf_counter()
        try:
            units = run.kind.request(run, i)
            run.sync()
        except Exception:
            run.failed += 1
            if run.failed == 1:
                traceback.print_exc()
            units = 0
    if i >= 0:
        run.records.append((i, t0, time.perf_counter(), units))


def run_cell(run: Run) -> dict:
    """Set up, warm up, measure, check; returns the result line's object
    (``checks`` last)."""
    run.kind.setup(run)
    for i in (-2, -1):  # two requests on the cell's own shapes
        _request(run, i)
    if run.failed:
        raise RuntimeError("a warm-up request failed")
    setup_s = time.perf_counter() - run.t_start
    _compile_report()
    summaries = []
    prof = contextlib.nullcontext()
    if run.trace:
        from . import devtrace

        prof = devtrace.profiled(os.path.join(run.workdir, "trace.json"), summaries)
    with prof:
        with run.span("window") if run.trace else contextlib.nullcontext():
            run.window_start = time.perf_counter()
            deadline = run.window_start + run.seconds
            i = 0
            while True:
                _request(run, i)
                i += 1
                if run.records[-1][2] >= deadline:
                    break
    run.summary = summaries[0] if summaries else None
    _latency_report(run)
    device = _device_line(run)
    e2e = run.kind.end_to_end(run)
    run.state.clear()
    gc.collect()
    t_check = time.perf_counter()
    checks = run.kind.check(run)
    print(f"check took {time.perf_counter() - t_check:.2f} s", file=sys.stderr)

    cell = run.cell["name"]
    metrics = {}
    if not run.trace:
        for m in run.spec["end_to_end"]:
            if _listed(m, cell):
                v = setup_s if m["name"] == "setup_s" else e2e[m["name"]]
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e_here = {m["name"] for m in run.spec["end_to_end"] if _listed(m, cell)}
        for m in run.spec["per_layer"]:
            if cell in m.get("workloads", [cell] if m["moves"] in e2e_here else []):
                v = metric_reader(run.root, m["name"]).read(run)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    correct = run.failed == 0 and all(v <= lim for v, lim in checks.values())
    out = {"correct": bool(correct), "attempted": len(run.records), "failed": run.failed,
           "metrics": metrics, "device": device}
    if run.summary is not None:
        out["breakdown"] = {"device_ops": run.summary.device_ops,
                            "idle_gaps": run.summary.idle_by_span}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return out


def _latency_report(run: Run) -> None:
    """The window's request latencies: a steadier view beside the rate."""
    lat = sorted(t1 - t0 for _, t0, t1, _ in run.records)
    q = [lat[min(len(lat) - 1, int(p * len(lat)))] * 1e3 for p in (0.1, 0.5, 0.9)]
    print(f"requests {len(lat)} in {run.window_s:.3f} s; latency ms p10 {q[0]:.2f}, p50 {q[1]:.2f}, "
          f"p90 {q[2]:.2f}, max {lat[-1] * 1e3:.2f}", file=sys.stderr)


def _compile_report() -> None:
    """The compile seconds of this run's kernels (0 where the library was
    already built in this checkout)."""
    from kmerseek_tpu_torch.ops import cuda_build

    print(f"compile seconds: {json.dumps(cuda_build.build_seconds)}", file=sys.stderr)


def _device_line(run: Run) -> dict:
    if run.device == "cpu":
        dev = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    else:
        import torch

        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": run.cell["chips"],
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    if run.summary is not None:
        dev["busy_s"] = run.summary.busy_s
        dev["window_s"] = run.summary.window_s
    return dev


def print_checks(checks: dict) -> None:
    for k, c in checks.items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
