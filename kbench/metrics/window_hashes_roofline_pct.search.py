"""The window-hash kernel's share of its roofline in the traced window:
the least time the window's query blocks need (1 B read per residue,
a 64-bit hash and a keep byte written per real window, or the int32
instructions of murmur3 and the filter per window, at the peaks of
``kbench.peaks``) over the summed device time of the kernel events whose
name holds ``window_hashes``. The work is what the window's requests
hashed for their sidecars (``run.work``: each block's residues and
windows)."""

import sys

from kbench.peaks import HBM_BYTES_PER_S, INT32_OPS_PER_S, murmur_int_ops


def read(run):
    t = run.summary
    if t is None:
        return None
    kernel = sum(s for name, s in t.kernel_s.items() if "window_hashes" in name)
    work = [w for i, w in run.work.items() if i >= 0]
    if kernel <= 0 or not work:
        return None
    residues = sum(w["residues"] for w in work)
    windows = sum(w["windows"] for w in work)
    t_bytes = (residues + 9 * windows) / HBM_BYTES_PER_S
    t_ops = windows * murmur_int_ops(run.config["ksize"]) / INT32_OPS_PER_S
    bound = max(t_bytes, t_ops)
    print(f"window_hashes: {kernel * 1e3:.4f} ms on the device, bound {bound * 1e3:.4f} ms "
          f"({'bytes' if t_bytes >= t_ops else 'operations'})", file=sys.stderr)
    return 100.0 * bound / kernel
