import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# cells cut to a size a CPU test run holds: the same code paths, fewer
# proteins, smaller blocks, a window of half a second
SMALL = {
    "config": {"target": {"proteins": 200, "giants": 1, "giant_min": 2500, "giant_max": 3000}},
    "traffic": {"block": {"size": 8}, "proteome": {"proteins": 80}, "pool_blocks_per_s": 4,
                "pool_proteomes_per_s": 4, "check_every": 2},
}
CELLS = ("hp24-search-b128", "p10-index-bacterial", "hp24-index-bacterial")


# cells whose request code, configuration and traffic stay in kbench/ but
# which are not in BENCHMARK.json: their runs swing with the host beyond
# what the largest bound holds (PERF.md section 7); a later PR can add
# them back as entries alone
LEFT_OUT = {
    "configs": [{"name": "protein-k10-s1", "source": "a test", "file": "kbench/configs/protein-k10-s1.json",
                 "reduced": [], "why": "a test"}],
    "workloads": [
        {"name": "p10-index-bacterial", "config": "protein-k10-s1", "traffic": "bacterial_proteome",
         "chips": 1, "why": "a test"},
        {"name": "hp24-index-bacterial", "config": "hp-k24-s5-human", "traffic": "bacterial_proteome",
         "chips": 1, "why": "a test"}],
    "end_to_end": [{"name": "index_residues_per_s", "unit": "residues/s", "better": "higher", "bound": 0.25,
                    "source": "host_clock", "workloads": ["p10-index-bacterial", "hp24-index-bacterial"]}],
    "per_layer": [
        {"name": n, "unit": u, "better": b, "source": src, "layer": "a test", "moves": "index_residues_per_s",
         "workloads": w}
        for n, u, b, src, w in (
            ("sketch_ms_per_mres.index", "ms/Mres", "lower", "host_clock", ["p10-index-bacterial", "hp24-index-bacterial"]),
            ("sigzip_ms_per_mres.index", "ms/Mres", "lower", "host_clock", ["hp24-index-bacterial"]),
            ("ksx_ms_per_mres.index", "ms/Mres", "lower", "host_clock", ["p10-index-bacterial", "hp24-index-bacterial"]),
            ("masked_sketch_roofline_pct.index", "%", "higher", "device_trace", ["p10-index-bacterial", "hp24-index-bacterial"]),
            ("device_idle_pct.index", "%", "lower", "device_trace", ["p10-index-bacterial", "hp24-index-bacterial"]))],
}


def spec():
    """``BENCHMARK.json`` with the left-out cells added, so that their
    request code is rehearsed with the others."""
    import json

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        s = json.load(f)
    names = {w["name"] for w in s["workloads"]}
    for key, entries in LEFT_OUT.items():
        s[key] += [e for e in entries if e["name"] not in names | {m["name"] for m in s[key]}]
    return s
