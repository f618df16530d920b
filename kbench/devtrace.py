"""The device's side of a traced window, read from ``torch.profiler``'s
Chrome trace (CUPTI): kernels, copies and memsets, and the harness's own
spans, which it records as ``record_function`` ranges named
``kbench/<span>``.

* ``busy_s``: the union of the device intervals inside the window;
* ``kernel_s``: summed device seconds by kernel name;
* ``device_ops``: the ten operations (kernels by name, copies by kind)
  that took the most device time;
* ``idle_by_span``: idle device time inside each span that the harness
  opens within a request (they do not nest), and between them.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

WINDOW = "kbench/window"
REQUEST = "kbench/request"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class TraceSummary(NamedTuple):
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]
    device_ops: List[Tuple[str, float]]
    idle_by_span: List[Tuple[str, float]]


@contextlib.contextmanager
def profiled(path: str, out: list):
    """Profile the body, export the trace to ``path``, and append its
    ``TraceSummary`` to ``out`` (the trace file is deleted after)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out.append(summarize(events))


def short_name(name: str) -> str:
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0][:80]


def _merge(iv: np.ndarray) -> np.ndarray:
    if not len(iv):
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    heads = np.flatnonzero(new)
    return np.stack([iv[heads, 0], ends[np.append(heads[1:] - 1, len(iv) - 1)]], 1)


def summarize(events: list) -> TraceSummary:
    win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"]
    if not win:
        raise RuntimeError("the trace holds no window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, kernel_s, ops = [], {}, {}
    for e in events:
        cat = e.get("cat")
        if cat not in DEVICE_CATS or e.get("ph") != "X":
            continue
        s = float(e["ts"])
        t = s + float(e.get("dur", 0))
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        dev.append((s, t))
        sec = (t - s) / 1e6
        name = e.get("name", cat)
        if cat == "kernel":
            kernel_s[name] = kernel_s.get(name, 0.0) + sec
            key = short_name(name)
        else:
            key = name
        ops[key] = ops.get(key, 0.0) + sec
    busy = _merge(np.array(dev, np.float64).reshape(-1, 2))
    cum = np.concatenate([[0.0], np.cumsum(busy[:, 1] - busy[:, 0])])

    def busy_until(x: float) -> float:
        i = int(np.searchsorted(busy[:, 0], x, "right"))
        if i == 0:
            return 0.0
        return float(cum[i - 1] + min(x, busy[i - 1, 1]) - busy[i - 1, 0])

    idle = {}
    leaves = [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"
              and str(e.get("name", "")).startswith("kbench/") and e["name"] not in (WINDOW, REQUEST)]
    in_spans = 0.0
    for e in leaves:
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e["dur"]), w1)
        if t <= s:
            continue
        gap = ((t - s) - (busy_until(t) - busy_until(s))) / 1e6
        name = e["name"][len("kbench/"):]
        idle[name] = idle.get(name, 0.0) + gap
        in_spans += gap
    busy_s = float(cum[-1]) / 1e6
    window_s = (w1 - w0) / 1e6
    idle["between spans"] = max(window_s - busy_s - in_spans, 0.0)
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10]  # noqa: E731
    return TraceSummary(window_s, busy_s, kernel_s, [list(x) for x in top(ops)],
                        [list(x) for x in top(idle)])
