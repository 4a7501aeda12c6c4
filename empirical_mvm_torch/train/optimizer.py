"""AdamW(0.9, 0.98) with the reference's four parameter groups, warmup-linear
schedule and global-norm clipping: the update of the JAX package's
``build_optimizer`` (``empirical_mvm_tpu/train/optimizer.py``), step for step.

* Groups (ref: agent.py:86-95): {swin, other} by whether "swin" is in the
  parameter's name, x {decay, nodecay}, no decay where the leaf name holds
  "bias" (a substring rule, so ``relative_position_bias_table`` too) or the
  parameter is a LayerNorm weight (flax calls it ``scale``; here it is found
  by module type). The swin groups take ``backbone_lr_mul``.
* Schedule (ref: agent.py:13-32): linear warmup over ``warmup_ratio`` of
  ``max_iter``, then linear decay, floored at ``min_lr``, evaluated at the
  update count before it increments (the first update uses lr(0)).
* Clip: gradients scaled by ``max_grad_norm / ||g||`` unless
  ``||g|| < max_grad_norm``, no epsilon (``optax.clip_by_global_norm``;
  ``torch.nn.utils.clip_grad_norm_`` would add 1e-6).
* AdamW as ``optax.adamw``: bias-corrected moments, ``eps`` outside the
  square root, decoupled weight decay added to the update before the
  learning rate scales it.

Parameters and moments are updated in place (``torch._foreach_*`` over each
group), which saves a copy of both; a parameter that received no gradient
is updated as with a zero gradient, as under ``jax.grad``.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from empirical_mvm_torch.ops.layernorm import LayerNorm

GROUPS = ("swin_decay", "swin_nodecay", "other_decay", "other_nodecay")
EPS = 1e-8          # Adam's epsilon in the JAX build_optimizer


def warmup_linear_factor(max_iter: int, warmup_ratio: float = 0.1) -> Callable[[int], float]:
    """The un-floored warmup/decay factor in [0, 1] (ref: agent.py:13-32)."""
    warmup = int(warmup_ratio * max_iter)

    def factor(step: int) -> float:
        step = min(step, max_iter)
        if step < warmup:
            return max(0.0, step / max(warmup, 1))
        return max(0.0, (max_iter - step) / max(max_iter - warmup, 1))

    return factor


def warmup_linear_schedule(base_lr: float, max_iter: int, warmup_ratio: float = 0.1,
                           min_lr: float = 1e-8) -> Callable[[int], float]:
    """(ref: agent.py:13-32)"""
    factor = warmup_linear_factor(max_iter, warmup_ratio)
    return lambda step: max(min_lr, base_lr * factor(step))


def group_labels(model: nn.Module) -> dict[str, str]:
    """Parameter name -> group, by the rule of ``default_group_fn``."""
    norm_weights = {id(m.weight) for m in model.modules() if isinstance(m, LayerNorm)}
    labels = {}
    for name, p in model.named_parameters():
        no_decay = "bias" in name.rsplit(".", 1)[-1] or id(p) in norm_weights
        labels[name] = (f"{'swin' if 'swin' in name else 'other'}_"
                        f"{'nodecay' if no_decay else 'decay'}")
    return labels


class AdamW:
    """The optimizer of ``build_optimizer`` over a model's parameters.

    ``init(params)`` returns the state (step count and both moments);
    ``update(params, grads, state)`` clips, updates moments and parameters
    in place and returns the state.
    """

    def __init__(self, model: nn.Module, lr: float, max_iter: int,
                 weight_decay: float = 1e-3, betas: tuple[float, float] = (0.9, 0.98),
                 warmup_ratio: float = 0.1, min_lr: float = 1e-8,
                 max_grad_norm: float = 1.0, backbone_lr_mul: float = 1.0):
        self.labels = group_labels(model)
        self.betas, self.max_grad_norm = betas, max_grad_norm
        mul = {"swin": backbone_lr_mul, "other": 1.0}
        self.schedules = {g: warmup_linear_schedule(lr * mul[g.split("_")[0]], max_iter,
                                                    warmup_ratio, min_lr) for g in GROUPS}
        self.weight_decay = {g: (weight_decay if g.endswith("_decay") else 0.0)
                             for g in GROUPS}

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        return {"count": 0,
                "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    @torch.no_grad()
    def update(self, params: dict[str, torch.Tensor],
               grads: dict[str, torch.Tensor | None], state: dict) -> dict:
        names = list(params)
        g = [grads[n] if grads[n] is not None else torch.zeros_like(params[n])
             for n in names]
        if self.max_grad_norm > 0:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
            factor = torch.where(norm < self.max_grad_norm, torch.ones_like(norm),
                                 self.max_grad_norm / norm)
            g = torch._foreach_mul(g, factor)
        count = state["count"] + 1
        b1, b2 = self.betas
        bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
        for group in GROUPS:
            idx = [i for i, n in enumerate(names) if self.labels[n] == group]
            if not idx:
                continue
            p = [params[names[i]] for i in idx]
            gg = [g[i] for i in idx]
            mu = [state["mu"][names[i]] for i in idx]
            nu = [state["nu"][names[i]] for i in idx]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, gg, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, gg, gg, value=1.0 - b2)
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, EPS)
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, den)
            if self.weight_decay[group]:
                torch._foreach_add_(upd, p, alpha=self.weight_decay[group])
            torch._foreach_add_(p, upd, alpha=-self.schedules[group](count - 1))
        state["count"] = count
        return state
