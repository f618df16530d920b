"""The masked sketch kernel's share of its roofline in the traced window:
the least time the window's sketch work needs (``kbench.peaks``: 1 B read
per residue, one 8-byte key written per real window, the int32
instructions of murmur3 and the filter per window) over the summed
device time of the kernel events whose name holds ``masked_sketch``.
The work is what the window's requests sketched (``run.work``): whole
proteomes in an index cell (``.index``), query blocks in a search cell
(``.search``)."""

import sys

from kbench.peaks import sketch_bound_s


def read(run):
    t = run.summary
    if t is None:
        return None
    kernel = sum(s for name, s in t.kernel_s.items() if "masked_sketch" in name)
    work = [w for i, w in run.work.items() if i >= 0]
    if kernel <= 0 or not work:
        return None
    bound, by = sketch_bound_s(sum(w["residues"] for w in work), sum(w["windows"] for w in work),
                               run.config["ksize"])
    print(f"masked_sketch: {kernel * 1e3:.4f} ms on the device, bound {bound * 1e3:.4f} ms "
          f"({by})", file=sys.stderr)
    return 100.0 * bound / kernel
