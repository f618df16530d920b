"""Smoke run of the PyTorch/CUDA port on one GPU: build, kernel checks,
and the main path (``kmerseek index`` → ``kmerseek search``) at the
scale of a human reference proteome.

    python3 chip_smoke.py [--seed N]

Phases (each prints its lines; any failure exits non-zero):

1. environment: torch version, the card's name and power limit; no CUDA
   device → exit 2;
2. build: compile every CUDA source of the port (one nvcc each, in
   parallel);
3. kernel vs plain version on the card: ``masked_window_keys`` against
   ``masked_window_keys_ref`` for 3 moltypes × 4 (k, scaled) × 3 shapes,
   keys and counts bit-equal (tolerance 0), a sample of windows against
   the scalar murmur oracle, then CUDA-event timings and the bound;
4. main path through ``python -m kmerseek_tpu_torch`` (run in this
   process, so launch counters are visible): a seeded synthetic proteome
   of 20,000 proteins (~11M residues, lognormal lengths, 4 titin-like
   giants) and 1,024 queries (half planted segments with ~5% point
   substitutions, half random). Checks: kernel launches > 0, the sparse
   device cross-check ran, every planted query reports its source, and
   the first 500 targets give the same ``.sig.zip`` and search CSV bytes
   with ``--device cpu`` as on the card;
5. a JSON line with every kernel's numbers, the ``nvidia-smi`` line, and
   the result line ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import runpy
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from kmerseek_tpu_torch.core.index import ProteomeIndex
from kmerseek_tpu_torch.core.search import _validate_with_device
from kmerseek_tpu_torch.ops import cuda_build
from kmerseek_tpu_torch.ops import sketch as sketch_mod
from kmerseek_tpu_torch.ops.encoding import encode_bytes_np, max_hash_for_scaled
from kmerseek_tpu_torch.ops.murmur3 import murmur64_bytes_py
from kmerseek_tpu_torch.ops.sketch_cuda import masked_window_keys, masked_window_keys_ref

AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
MOLTYPES = ("protein", "dayhoff", "hp")
K_SCALED = ((5, 1), (10, 1), (16, 5), (24, 5))
SOURCES = ("masked_sketch.cu",)

# H100 SXM peaks (NVIDIA data sheet / Hopper white paper): HBM3 bandwidth,
# and the INT32 instruction rate = 132 SMs x 64 INT32 lanes x SM clock
HBM_BYTES_PER_S = 3.35e12
SMS, INT32_LANES = 132, 64


def log(*a):
    print(*a, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def murmur_int_ops(k: int) -> int:
    """32-bit integer instructions murmur3 x64_128 (first lane) + the
    scaled filter need for one k-byte window, counting a 64-bit multiply
    as 3 (lo*lo wide + two cross terms) and a 64-bit add, xor, shift,
    rotate or compare as 2."""
    mul, other = 0, 0
    blocks, tail = divmod(k, 16)
    mul += blocks * 6  # k1, k2: 2 each; h1*5, h2*5
    other += blocks * 12  # 2 rotl + xor per lane, h rotl + 2 adds per lane
    if tail > 8:
        mul, other = mul + 2, other + 2
    if tail > 0:
        mul, other = mul + 2, other + 2
    other += 4  # length xors, h1 += h2, h2 += h1
    mul += 4  # two fmix64: 2 multiplies each
    other += 6 * 2 + 1 + 2  # fmix shift+xor pairs, final add, filter compare+select
    return 3 * mul + 2 * other


def kernel_bound_ms(B: int, L: int, k: int, sm_clock_hz: float):
    W = L - k + 1
    nbytes = B * L + 4 * B + 8 * B * W + 4 * B
    ops = B * W * murmur_int_ops(k)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / (SMS * INT32_LANES * sm_clock_hz)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sm_clock_hz() -> float:
    try:
        return float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    except (ValueError, subprocess.CalledProcessError):
        return 1.98e9


def event_median_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_phase(rng, dev) -> dict:
    shapes = {"1024x1024": (1024, 1024), "8x32768": (8, 32768), "ragged": (16, 1024)}
    max_err = 0.0
    n_checked = 0
    for label, (B, L) in shapes.items():
        seqs_np = AA[rng.integers(0, 20, size=(B, L))]
        lens_np = rng.integers(0, L + 1, size=B).astype(np.int32)
        for moltype in MOLTYPES:
            enc = encode_bytes_np(seqs_np, moltype)
            for k, scaled in K_SCALED:
                lens = lens_np.copy()
                if label == "ragged":
                    lens[:4] = [0, k - 1, k, L]
                seqs = torch.from_numpy(seqs_np).to(dev)
                lt = torch.from_numpy(lens).to(dev)
                keys, cnt = masked_window_keys(seqs, lt, k=k, scaled=scaled, moltype=moltype)
                rkeys, rcnt = masked_window_keys_ref(seqs, lt, k=k, scaled=scaled, moltype=moltype)
                torch.cuda.synchronize()
                diff = (keys != rkeys).sum().item() + (cnt != rcnt).sum().item()
                if diff:
                    err = (keys.double() - rkeys.double()).abs().max().item()
                    max_err = max(max_err, err, 1.0)
                    raise SystemExit(
                        f"kernel disagrees with its plain version: {label} {moltype} "
                        f"k={k} scaled={scaled}: {diff} mismatches"
                    )
                if label == "ragged" and not (cnt[0] == 0 and cnt[1] == 0):
                    raise SystemExit(f"rows shorter than k kept windows (k={k})")
                # scalar oracle on sampled windows
                h = keys.cpu().numpy().view(np.uint64)
                mh = max_hash_for_scaled(scaled)
                for _ in range(24):
                    b = int(rng.integers(0, B))
                    j = int(rng.integers(0, L - k + 1))
                    ref = murmur64_bytes_py(bytes(enc[b, j : j + k]))
                    kept = j < lens[b] - k + 1 and ref <= mh
                    want = ref if kept else 2**64 - 1
                    if int(h[b, j]) != want:
                        raise SystemExit(f"kernel disagrees with murmur oracle at {label} {moltype} k={k} ({b},{j})")
                    n_checked += 1
        log(f"kernel check {label} (B={B}, L={L}): 12 configs bit-equal")
    log(f"kernel check: 36 configs bit-equal, {n_checked} sampled windows match the scalar oracle")

    # timing at the main path's largest common shape, hp/k24/scaled5
    B, L, k, scaled = 1024, 1024, 24, 5
    seqs = torch.from_numpy(AA[rng.integers(0, 20, size=(B, L))]).to(dev)
    lt = torch.from_numpy(rng.integers(L // 2, L + 1, size=B).astype(np.int32)).to(dev)
    ms = event_median_ms(lambda: masked_window_keys(seqs, lt, k=k, scaled=scaled, moltype="hp"), 50)
    plain_ms = event_median_ms(
        lambda: masked_window_keys_ref(seqs, lt, k=k, scaled=scaled, moltype="hp"), 20
    )
    clock = sm_clock_hz()
    bound_ms, bound_by = kernel_bound_ms(B, L, k, clock)
    log(
        f"kernel timing (B={B}, L={L}, hp/k{k}/scaled{scaled}, median of 50 CUDA-event runs): "
        f"{ms:.4f} ms kernel, {plain_ms:.4f} ms plain version; bound {bound_ms:.4f} ms "
        f"({bound_by}; {murmur_int_ops(k)} int32 ops/window at {clock / 1e6:.0f} MHz); "
        f"{B * (L - k + 1) / ms / 1e6:.2f} G windows/s"
    )
    return {
        "name": "masked_window_keys",
        "route": "cuda",
        "source": "kmerseek_tpu_torch/csrc/masked_sketch.cu",
        "replaces": "kmerseek_tpu/ops/sketch_pallas.py:98",
        "launches": None,  # filled from the main path's run
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this function
    }


# ---------------------------------------------------------------------------
# main-path phase
# ---------------------------------------------------------------------------


def make_corpus(rng, n_targets=20000, n_queries=1024):
    """Targets: lognormal lengths (median ~415, mean ~560 aa) plus four
    titin-like giants; queries: half planted segments of 50-300 aa from
    known targets with ~5% point substitutions, half random."""
    lens = np.clip(rng.lognormal(np.log(415), 0.774, size=n_targets), 30, 15000).astype(int)
    giants = rng.choice(n_targets, size=4, replace=False)
    lens[giants] = rng.integers(20000, 34351, size=4)
    targets = [AA[rng.integers(0, 20, size=n)].tobytes() for n in lens]
    queries, planted = [], {}
    while len(planted) < n_queries // 2:
        t = int(rng.integers(0, n_targets))
        n = int(min(rng.integers(50, 301), len(targets[t])))
        a = int(rng.integers(0, len(targets[t]) - n + 1))
        seg = np.frombuffer(targets[t][a : a + n], np.uint8).copy()
        sub = rng.random(n) < 0.05
        seg[sub] = AA[rng.integers(0, 20, size=int(sub.sum()))]
        # keep only segments that still share a kept hash with their
        # source, by the scalar oracle (independent of the port)
        if _oracle_hashes(seg.tobytes()) & _oracle_hashes(targets[t][a : a + n]):
            planted[f"planted{len(planted)} src=t{t}"] = f"t{t}"
            queries.append(seg.tobytes())
    names = list(planted)
    for i in range(n_queries - len(queries)):
        queries.append(AA[rng.integers(0, 20, size=int(rng.integers(50, 301)))].tobytes())
        names.append(f"random{i}")
    return targets, lens, queries, names, planted


def _oracle_hashes(seq: bytes, k=24, scaled=5) -> set:
    enc = encode_bytes_np(np.frombuffer(seq, np.uint8), "hp").tobytes()
    mh = max_hash_for_scaled(scaled)
    hs = (murmur64_bytes_py(enc[j : j + k]) for j in range(len(enc) - k + 1))
    return {h for h in hs if h <= mh}


def write_fasta(path, names, seqs):
    with open(path, "w") as f:
        for n, s in zip(names, seqs):
            f.write(f">{n}\n")
            for j in range(0, len(s), 60):
                f.write(s[j : j + 60].decode() + "\n")


def kmerseek(*args):
    """``python -m kmerseek_tpu_torch ARGS``, run in this process."""
    argv = sys.argv
    sys.argv = ["kmerseek_tpu_torch", *args]
    try:
        runpy.run_module("kmerseek_tpu_torch", run_name="__main__", alter_sys=True)
    except SystemExit as e:
        if e.code not in (0, None):
            raise SystemExit(f"kmerseek {' '.join(args)} failed with exit {e.code}")
    finally:
        sys.argv = argv


class KernelTimer:
    """Times every sketch-kernel wrapper call of the main path with CUDA
    events around it: the span holds the kernel and the host's launch
    overhead (allocation, ctypes call). The wrapper's own launch count is
    untouched. ``profile_torch_main_path.py`` gives device-only time."""

    def __init__(self, sm_clock_hz: float):
        self.events = []
        self.bound_ms = 0.0  # summed bound of the timed calls' shapes
        self.clock = sm_clock_hz
        self.real = sketch_mod.masked_window_keys

    def __call__(self, seqs, lengths, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.real(seqs, lengths, **kw)
        end.record()
        self.events.append((start, end))
        self.bound_ms += kernel_bound_ms(*seqs.shape, kw["k"], self.clock)[0]
        return out

    def total_ms(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def main_path_phase(rng, workdir) -> int:
    t0 = time.perf_counter()
    targets, lens, queries, qnames, planted = make_corpus(rng)
    tnames = [f"t{i}" for i in range(len(targets))]
    tfa, qfa = os.path.join(workdir, "target.fa"), os.path.join(workdir, "query.fa")
    write_fasta(tfa, tnames, targets)
    write_fasta(qfa, qnames, queries)
    log(
        f"corpus: {len(targets)} targets, {int(lens.sum())} residues "
        f"(median {int(np.median(lens))}, mean {lens.mean():.0f}, max {lens.max()}); "
        f"{len(queries)} queries ({len(planted)} planted); made in {time.perf_counter() - t0:.1f} s"
    )

    timer = KernelTimer(sm_clock_hz())
    sketch_mod.masked_window_keys = timer
    masked_window_keys.launches = 0
    _validate_with_device.runs = 0
    try:
        t0 = time.perf_counter()
        kmerseek("index", tfa)
        torch.cuda.synchronize()
        t_index = time.perf_counter() - t0
        out = os.path.join(workdir, "search.csv")
        t0 = time.perf_counter()
        kmerseek("search", qfa, tfa, "--output", out)
        torch.cuda.synchronize()
        t_search = time.perf_counter() - t0
    finally:
        sketch_mod.masked_window_keys = timer.real
    launches = masked_window_keys.launches
    validations = _validate_with_device.runs
    kernel_ms = timer.total_ms()

    idx = ProteomeIndex.load(f"{tfa}.hp.k24.scaled5.sig.zip.ksx", device="cuda")
    windows = int(np.maximum(lens - 24 + 1, 0).sum())
    with open(out) as f:
        rows = list(csv.DictReader(f))
    found = {(r["query_name"], r["match_name"]) for r in rows}
    missing = [q for q, t in planted.items() if (q, t) not in found]
    bad = [r for r in rows if not (0.0 < float(r["containment"]) <= 1.0)]
    log(
        f"main path: index {t_index:.2f} s, search {t_search:.2f} s (host clock, incl. file I/O); "
        f"{len(idx.mins)} kept hashes, {idx.inverted.n_postings} postings, "
        f"max_run {idx.inverted.max_run}; {windows / t_index / 1e6:.2f} M windows/s end to end"
    )
    log(
        f"main path: sketch kernel launches {launches}, summed wrapper span {kernel_ms:.3f} ms "
        f"(CUDA events around each wrapper call: kernel + host launch overhead), "
        f"summed bound {timer.bound_ms:.3f} ms; sparse cross-check runs {validations}; "
        f"{len(rows)} result rows, planted found {len(planted) - len(missing)}/{len(planted)}"
    )
    if launches <= 0:
        raise SystemExit("the main path launched no sketch kernel")
    if validations <= 0:
        raise SystemExit("the sparse device cross-check never ran")
    if missing:
        raise SystemExit(f"{len(missing)} planted queries miss their source, e.g. {missing[:3]}")
    if bad:
        raise SystemExit(f"{len(bad)} rows with containment outside (0, 1]")

    # card vs CPU on the first 500 targets: same bytes
    sub = os.path.join(workdir, "sub", "target500.fa")
    os.makedirs(os.path.dirname(sub))
    write_fasta(sub, tnames[:500], targets[:500])
    results = {}
    for device in ("cuda", "cpu"):
        kmerseek("index", sub, "--device", device, "--force")
        with open(f"{sub}.hp.k24.scaled5.sig.zip", "rb") as f:
            sig = f.read()
        csv_out = os.path.join(workdir, "sub", f"{device}.csv")
        kmerseek("search", qfa, sub, "--device", device, "--force", "--output", csv_out)
        with open(csv_out, "rb") as f:
            results[device] = (sig, f.read())
    if results["cuda"][0] != results["cpu"][0]:
        raise SystemExit("first-500 .sig.zip bytes differ between the card and the CPU")
    if results["cuda"][1] != results["cpu"][1]:
        raise SystemExit("first-500 search CSV bytes differ between the card and the CPU")
    n_rows = results["cpu"][1].count(b"\n") - 1
    log(
        f"first 500 targets: .sig.zip ({len(results['cpu'][0])} B) and search CSV "
        f"({n_rows} rows) identical on the card and the CPU"
    )
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    log(f"torch {torch.__version__} (CUDA {torch.version.cuda})")
    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke needs a GPU")
        return 2
    smi = nvidia_smi("name,power.limit")
    log(f"card: {smi}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

    t0 = time.perf_counter()
    secs = cuda_build.build_all(SOURCES)
    log(f"build: {secs} (wall {time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    entry = kernel_phase(rng, dev)
    log(f"kernel phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="kmerseek-smoke-") as workdir:
        entry["launches"] = main_path_phase(rng, workdir)
    log(f"main-path phase: {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"kernels": [entry]}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
