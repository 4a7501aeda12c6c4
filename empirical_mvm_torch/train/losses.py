"""Pretrain losses (counterpart of ``empirical_mvm_tpu/train/losses.py:16-47``)."""

from __future__ import annotations

import torch


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = -1) -> torch.Tensor:
    """Mean cross entropy over positions whose label != ignore_index, in
    fp32 (``T.nn.CrossEntropyLoss(ignore_index=-1)``, ref: agent.py:57).
    logits (..., V), labels (...) int."""
    v = logits.shape[-1]
    lf = logits.reshape(-1, v).float()
    lab = labels.reshape(-1).long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    ls = torch.logsumexp(lf, dim=-1) - lf.gather(1, safe[:, None])[:, 0]
    return torch.where(valid, ls, 0.0).sum() / valid.sum().clamp(min=1)


def masked_l1(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
              channel_div: float = 1.0) -> torch.Tensor:
    """sum(|pred - target| * mask) / (sum(mask) + 1e-5) / channel_div, with
    mask summed as given (before it broadcasts over channels)
    (ref: main_pretrain.py:429-430)."""
    err = (pred.float() - target.float()).abs()
    m = mask.float()
    return (err * m).sum() / (m.sum() + 1e-5) / channel_div
