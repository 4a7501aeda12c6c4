"""On-device preprocessing: uint8 clips -> ImageNet-normalized float
(counterpart of ``empirical_mvm_tpu/ops/preprocess.py:21-34``). The loader
ships uint8 clips, a quarter of the bytes of fp32, and the model normalizes
them where they land."""

from __future__ import annotations

import functools

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@functools.lru_cache(maxsize=None)
def _mean_std(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The ImageNet mean and std on ``device``, made once: a copy from the
    host to the card waits for the card's queue to drain."""
    return (torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device),
            torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device))


def normalize_uint8(img: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 (..., 3) -> normalized float."""
    mean, std = _mean_std(img.device)
    x = img.float() / 255.0
    return ((x - mean) / std).to(dtype)


def maybe_normalize(img: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Normalize uint8 clips; pass float clips through unchanged."""
    if img.dtype == torch.uint8:
        return normalize_uint8(img, dtype)
    return img
