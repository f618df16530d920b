"""The precision control of the stitched search cells: the plain
reference's k-mer sidecar put in the program's place, with the hashes
carried through float64 (the configuration states uint64), run through
the whole harness; the program's own stitcher reads it. The check must
come out not correct. (``kbench/control.py`` is the control of the other
kinds.)

    python3 kbench/control_stitch.py --workload <cell> --seeds 1,2,3 --seconds 30

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

from kbench.reference import stitch  # noqa: E402


@contextlib.contextmanager
def patched(run):
    import pyarrow as pa
    import pyarrow.parquet as pq

    from kmerseek_tpu_torch.core import kmers as program

    cfg = run.config
    k, scaled, moltype = cfg["ksize"], cfg["scaled"], cfg["moltype"]

    def write_kmer_table_for_index(index, path, sequence_file=None):
        fasta = index.source_fasta
        w = stitch.kept_windows(fasta, k, scaled, moltype, hash_dtype=np.float64)
        cols = stitch.sidecar_columns(w, k, sequence_file or os.path.abspath(fasta))
        pq.write_table(pa.Table.from_pydict(cols, schema=program.KMERS_SCHEMA), path)
        return path

    with mock.patch.object(program, "write_kmer_table_for_index", write_kmer_table_for_index):
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
