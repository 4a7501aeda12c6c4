"""Metrics logging (counterpart of ``empirical_mvm_tpu/train/metrics.py``;
ref: utils/logger.py, the wandb gate at utils/lib.py:28-35):
:class:`MetricsLogger`, JSONL scalars on disk, always; a wandb mirror when
``WANDB_ENABLE=1`` and wandb imports (a warning where it does not). The
profiler window of the run loop is ``core/tracing.py``'s.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any

logger = logging.getLogger(__name__)

WANDB_ENABLE = bool(int(os.environ.get("WANDB_ENABLE", "0")))


class MetricsLogger:
    """Append-only JSONL scalar log and an optional wandb mirror."""

    def __init__(self, out_dir: str, run_name: str = "run", use_wandb: bool | None = None):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self._fh = open(self.path, "a", buffering=1)
        self._wandb = None
        if use_wandb if use_wandb is not None else WANDB_ENABLE:
            try:
                import wandb
                self._wandb = wandb
                wandb.init(project=f"empirical_mvm_torch_{run_name}", dir=out_dir)
            except Exception as e:  # noqa: BLE001 — the JSONL log goes on without it
                logger.warning("wandb unavailable: %s", e)

    def log(self, scalars: dict[str, Any], step: int) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._fh.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)

    def close(self) -> None:
        self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()
