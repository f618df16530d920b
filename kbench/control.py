"""The precision control: the plain reference put in the program's place
and computed one precision lower, run through the whole harness; the
check must come out not correct.

* search cells: ``manysearch`` replaced by the reference's, with the
  statistics in float32 (the configuration states float64);
* index cells: ``ProteomeIndex.build`` replaced by the reference's
  sketch with the hashes carried through float64 (the configuration
  states uint64); the program's own writers persist it.

    python3 kbench/control.py --workload <cell> --seeds 1,2,3 --seconds 5

prints each seed's check numbers. The benchmark's own runs never run it.
"""

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.join(ROOT, "kbench"):
    sys.path[0] = ROOT

import numpy as np  # noqa: E402

from kbench.reference import search, sketch  # noqa: E402


@contextlib.contextmanager
def patched(run):
    cfg = run.config
    k, scaled, moltype = cfg["ksize"], cfg["scaled"], cfg["moltype"]
    if run.traffic["kind"] == "search_blocks":
        from kmerseek_tpu_torch.core import search as program

        cache = {}

        def manysearch(query, target, threshold=0.0):
            if "t" not in cache:
                t = sketch.sketch_fasta(run.target_fasta, k, scaled, moltype)
                cache["t"] = search.TargetStats(t, sketch.postings(t), k)
            q = sketch.sketch_fasta(query.source_fasta, k, scaled, moltype)
            return search.manysearch(q, cache["t"], scaled, moltype, dtype=np.float32)

        with mock.patch.object(program, "manysearch", manysearch):
            yield
        return
    from kmerseek_tpu_torch.core.index import IndexConfig, ProteomeIndex
    from kmerseek_tpu_torch.core.signature import Signature

    def build(cls, fasta, config=None, **kw):
        s = sketch.sketch_fasta(fasta, k, scaled, moltype, hash_dtype=np.float64)
        sigs = [Signature(name=n, mins=s.mins[a:b], abundances=s.abundances[a:b], ksize=k,
                          scaled=scaled, moltype=moltype, filename=os.path.abspath(fasta))
                for n, a, b in zip(s.names, s.offsets[:-1], s.offsets[1:])]
        return ProteomeIndex.from_signatures(sigs, IndexConfig(k, scaled, moltype), source_fasta=fasta,
                                             device=kw.get("device"))

    with mock.patch.object(ProteomeIndex, "build", classmethod(build)):
        yield


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5)
    args = ap.parse_args(argv)
    from kbench import harness

    spec = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for seed in [int(s) for s in args.seeds.split(",")]:
        workdir = tempfile.mkdtemp(prefix="kbench-control-", dir=os.path.abspath(tempfile.gettempdir()))
        try:
            run = harness.Run(spec, args.workload, seed, args.seconds, False, "cuda", workdir)
            with patched(run):
                out = harness.run_cell(run)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": True,
                          "correct": out["correct"], "attempted": out["attempted"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
