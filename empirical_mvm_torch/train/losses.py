"""Losses (counterpart of ``empirical_mvm_tpu/train/losses.py``): the cross
entropy of the MTM, MC and QA heads, the bidirectional InfoNCE of retrieval
fine-tuning, the masked L1 of the MVM targets, the label-smoothed NLL of
captioning and the masked accuracy.

Inside ``parallel.mesh.data_parallel`` each loss is this rank's share of the
global batch's loss: its denominators (valid counts, mask sums, the batch)
are summed over the ranks, so the shares add up to the one-process loss and
their gradients to its gradient.
"""

from __future__ import annotations

import torch

from empirical_mvm_torch.parallel.mesh import gather_rows, global_sum, local_rows


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
    return torch.where(valid, ls, 0.0).sum() / global_sum(valid.sum()).clamp(min=1)


def norm_softmax_loss(scores: torch.Tensor, temperature: float = 0.05) -> torch.Tensor:
    """Bidirectional InfoNCE on a (B, B) score matrix whose matched pairs lie
    on the diagonal (ref: agent.py:34-50): the scores in fp32 divided by the
    temperature, minus the mean diagonal log-softmax over rows and over
    columns.

    Data parallel, ``scores`` holds this rank's videos (B / W, B): the rows
    are gathered into the whole matrix, and the share is the terms of this
    rank's rows and of its captions' columns (every row and column at W = 1)."""
    s = gather_rows(scores.float() / temperature)
    b = s.shape[0]
    own = local_rows(torch.arange(b, device=s.device))
    rows = torch.log_softmax(s[own], dim=1).gather(1, own[:, None])
    cols = torch.log_softmax(s.T[own], dim=1).gather(1, own[:, None])
    return -(rows.sum() + cols.sum()) / b


def masked_l1(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
              channel_div: float = 1.0) -> torch.Tensor:
    """sum(|pred - target| * mask) / (sum(mask) + 1e-5) / channel_div, with
    mask summed as given (before it broadcasts over channels)
    (ref: main_pretrain.py:429-430)."""
    err = (pred.float() - target.float()).abs()
    m = mask.float()
    return (err * m).sum() / (global_sum(m.sum()) + 1e-5) / channel_div


def label_smoothed_nll(logits: torch.Tensor, labels: torch.Tensor, epsilon: float = 0.1,
                       ignore_index: int = -1) -> torch.Tensor:
    """Label-smoothed NLL of captioning over the positions whose label !=
    ignore_index, in fp32: (1 - epsilon) NLL + epsilon times the mean
    negative log-probability over the vocabulary, summed and divided by the
    count of such positions (at least 1) (ref: model_for_captioning.py:8-33).
    logits (..., V), labels (...) int."""
    v = logits.shape[-1]
    logp = torch.log_softmax(logits.reshape(-1, v).float(), dim=-1)
    lab = labels.reshape(-1).long()
    valid = lab != ignore_index
    nll = -logp.gather(1, torch.where(valid, lab, 0)[:, None])[:, 0]
    ls = (1.0 - epsilon) * nll - epsilon * logp.mean(dim=-1)
    return torch.where(valid, ls, 0.0).sum() / global_sum(valid.sum()).clamp(min=1)


def masked_accuracy(pred_ids: torch.Tensor, labels: torch.Tensor,
                    ignore_index: int = -1) -> torch.Tensor:
    """Share of the positions whose label != ignore_index that ``pred_ids``
    gets right, 0 where there is none (ref: main_pretrain.py:577-578)."""
    valid = labels != ignore_index
    correct = (pred_ids == labels) & valid
    return correct.sum() / global_sum(valid.sum()).clamp(min=1)
