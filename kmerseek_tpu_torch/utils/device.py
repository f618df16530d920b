"""Device selection for the port's entry points.

Entry points run on the CUDA device unless the caller names another.
There is no silent fallback: asking for CUDA on a machine without a
usable GPU raises, and the CPU is used only when asked for by name.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; a CUDA request without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(CLI: --device cpu) to run on the CPU"
        )
    return dev
