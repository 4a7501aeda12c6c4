"""Metrics logging and profiling (counterpart of
``empirical_mvm_tpu/train/metrics.py``; ref: utils/logger.py, the wandb gate
at utils/lib.py:28-35, agent.py:143-154 memory line).

* :class:`MetricsLogger`: JSONL scalars on disk, always; a wandb mirror when
  ``WANDB_ENABLE=1`` and wandb imports (a warning where it does not).
* :func:`profile_steps`: a ``torch.profiler`` window written as a Chrome
  trace.
* :func:`device_memory_stats`: bytes allocated on each card
  (``torch.cuda.memory_stats``), the reference's
  ``max_memory_allocated`` log line.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Any

import torch

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


def profiler(device: torch.device) -> torch.profiler.profile:
    """A profiler of the host and, on a card, its kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def write_trace(prof: torch.profiler.profile, out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)
    return path


@contextlib.contextmanager
def profile_steps(out_dir: str, device="cuda"):
    """Profile the enclosed steps; the Chrome trace goes to
    ``out_dir/trace.json`` (view it in chrome://tracing or Perfetto)."""
    prof = profiler(device)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        write_trace(prof, out_dir)


def device_memory_stats() -> dict[str, int]:
    """Bytes allocated on each card, where there is one."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": int(torch.cuda.memory_stats(i).get("allocated_bytes.all.current", 0))
            for i in range(torch.cuda.device_count())}
