"""Search traffic against a target too large for the reference's one-pass
sketch: ``search_blocks`` with the target sketched in chunks for the
check.

Set-up, the requests and the end-to-end metrics are ``search_blocks``'s
own functions, so the timed path is the same code: the target's ``.ksx``
built and loaded in set-up, and a request is one block through
``ProteomeIndex.build``, ``manysearch`` and ``write_search_csv``.

The check is ``search_blocks.check`` itself (the same sample of blocks,
postings, manysearch, comparison and limits) with the reference's
``sketch_fasta`` read as ``sketch_chunked.sketch_fasta_chunked``: the
target's proteins cut into contiguous chunks sketched by a pool of
processes, bit-equal to the one-pass sketch (a query block is one chunk,
sketched in this process). It prints its peak resident memory, this
process's and, where the system reports it, its largest worker's.
"""

from __future__ import annotations

import resource
import sys
from unittest import mock

from kbench.kinds import search_blocks
from kbench.kinds.search_blocks import end_to_end, request, setup  # noqa: F401
from kbench.reference import sketch, sketch_chunked


def check(run) -> dict:
    with mock.patch.object(sketch, "sketch_fasta", sketch_chunked.sketch_fasta_chunked):
        out = search_blocks.check(run)
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    worker = sketch_chunked.last_worker_peak_bytes / 2**30
    print(f"peak RSS {rss:.2f} GiB, largest check worker "
          + (f"{worker:.2f} GiB" if worker else "not reported (no VmHWM)"), file=sys.stderr)
    return out
