"""stderr logging (counterpart of ``kmerseek_tpu/utils/logging.py``)."""

from __future__ import annotations

import logging
import sys

logger = logging.getLogger("kmerseek_tpu_torch")


def setup_logging(debug: bool = False) -> None:
    level = logging.DEBUG if debug else logging.INFO
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    )
    logger.setLevel(level)
    if not logger.handlers:
        logger.addHandler(handler)
    else:
        for h in logger.handlers:
            h.setLevel(level)
