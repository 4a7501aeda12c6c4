"""The single-process part of ``empirical_mvm_tpu/parallel/mesh.py``: tail
batches padded to the step's batch size, the main-process gate and the
metric gather (the identity on one process). Data parallelism across cards
is not ported."""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist


def pad_batch(batch: dict[str, Any], target_b: int) -> tuple[dict[str, Any], int]:
    """Pad every tensor's leading dim to ``target_b`` by repeating the last
    row; returns (padded batch, n_valid). Other values (lists of ids) pass
    as they are. Used for eval tail batches."""
    def rows(x):
        return isinstance(x, torch.Tensor) and x.ndim > 0

    b = next(v for v in batch.values() if rows(v)).shape[0]
    if b == target_b:
        return batch, b
    if b > target_b:
        raise ValueError(f"a batch of {b} rows is larger than {target_b}")
    return {k: torch.cat([v] + [v[-1:]] * (target_b - b)) if rows(v) else v
            for k, v in batch.items()}, b


def is_main_process() -> bool:
    """Rank 0 of ``torch.distributed`` when it is initialised, else true
    (ref: utils/dist.py:107-111)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def all_gather_metrics(values: list[float]) -> list[float]:
    """Every process's metric list, concatenated (ref: utils/dist.py:187-227):
    the identity on one process."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError("data parallelism across processes is not ported")
    return list(values)
