"""The precision control of the ``search_blocks_chunked`` cells:
``manysearch`` replaced by the plain reference's with the statistics in
float32 (the configuration states float64), the target sketched in
chunks as the kind's check sketches it, run through the whole harness;
the check must come out not correct. (``kbench/control.py`` is the
control of the other kinds; this one runs its ``main``.)

    python3 kbench/control_chunked.py --workload <cell> --seeds 1,2,3 --seconds 30

prints each seed's check numbers. The benchmark's own runs never run it.
"""

import contextlib
import os
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.join(ROOT, "kbench"):
    sys.path[0] = ROOT

import numpy as np  # noqa: E402

from kbench import control  # noqa: E402
from kbench.reference import search, sketch, sketch_chunked  # noqa: E402


@contextlib.contextmanager
def patched(run):
    from kmerseek_tpu_torch.core import search as program

    cfg = run.config
    k, scaled, moltype = cfg["ksize"], cfg["scaled"], cfg["moltype"]
    cache = {}

    def manysearch(query, target, threshold=0.0):
        if "t" not in cache:
            t = sketch_chunked.sketch_fasta_chunked(run.target_fasta, k, scaled, moltype)
            cache["t"] = search.TargetStats(t, sketch.postings(t), k)
        q = sketch.sketch_fasta(query.source_fasta, k, scaled, moltype)
        return search.manysearch(q, cache["t"], scaled, moltype, dtype=np.float32)

    with mock.patch.object(program, "manysearch", manysearch):
        yield


def main(argv=None) -> int:
    with mock.patch.object(control, "patched", patched):
        return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())
