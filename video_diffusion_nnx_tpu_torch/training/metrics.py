"""Metrics writers (counterpart of the JAX package's training/metrics.py:19-50).

TensorBoard's ``SummaryWriter`` when it imports, else a JSONL file with the
same ``add_scalar(tag, value, step)`` / ``flush()`` / ``close()`` surface.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path

logger = logging.getLogger(__name__)


class JsonlSummaryWriter:
    """One JSON line per scalar, in ``<log_dir>/metrics.jsonl``."""

    def __init__(self, log_dir: str):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._file = open(self.log_dir / "metrics.jsonl", "a", buffering=1)

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._file.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                     "ts": time.time()}) + "\n")

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        self._file.close()


def create_summary_writer(log_dir: str):
    """TensorBoard's writer when it imports, else :class:`JsonlSummaryWriter`."""
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir=str(log_dir))
    except Exception as e:
        logger.info("TensorBoard unavailable (%s); writing JSONL metrics", e)
        return JsonlSummaryWriter(log_dir)
