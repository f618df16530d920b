"""Performance configuration (counterpart of
``kmerseek_tpu/utils/config.py``, reduced to what the port reads).

``batch_size`` and ``progress_interval`` feed ``ProteomeIndex.build``'s
ingest loop through the process-wide default. The JAX package's
``vmem_budget_bytes`` (a TPU block-size budget) has no counterpart:
the CUDA kernel's block shape is fixed.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PerformanceConfig:
    batch_size: int = 1000  # sequences per ingest batch
    enable_metrics: bool = False  # progress logging during builds
    progress_interval: int = 1000


_default_perf = PerformanceConfig()


def get_default_performance_config() -> PerformanceConfig:
    return _default_perf
