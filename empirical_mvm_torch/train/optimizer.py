"""AdamW(0.9, 0.98) with the reference's four parameter groups, warmup-linear
schedule and global-norm clipping: the update of the JAX package's
``build_optimizer`` (``empirical_mvm_tpu/train/optimizer.py``), step for step.
:func:`build_optimizer` builds it from a run's ``TrainConfig``.

* Groups (ref: agent.py:86-95): {swin, other} by whether "swin" is in the
  parameter's name, x {decay, nodecay}, no decay where the leaf name holds
  "bias" (a substring rule, so ``relative_position_bias_table`` too) or the
  parameter is a LayerNorm or BatchNorm weight (flax calls both ``scale``;
  here they are found by module type). The BatchNorm running statistics are
  buffers, outside every group: the JAX package labels them ``other_decay``
  (its ``mean`` and ``var`` parameters), so its weight decay shrinks them
  (ROADMAP Queue 3), which the port does not copy. The swin groups take ``backbone_lr_mul``.
* Schedule (ref: agent.py:13-32): linear warmup over ``warmup_ratio`` of
  ``max_iter``, then linear decay, floored at ``min_lr``, evaluated at the
  update count before it increments (the first update uses lr(0)).
* Clip: gradients scaled by ``max_grad_norm / ||g||`` unless
  ``||g|| < max_grad_norm``, no epsilon (``optax.clip_by_global_norm``;
  ``torch.nn.utils.clip_grad_norm_`` would add 1e-6).
* AdamW as ``optax.adamw``: bias-corrected moments, ``eps`` outside the
  square root, decoupled weight decay added to the update before the
  learning rate scales it.
* A fifth label, ``frozen`` (the JAX ``optax.set_to_zero`` group): every
  parameter with ``requires_grad`` off, and the names in ``frozen``. A
  frozen parameter has no moments and is never changed. The model turns
  ``requires_grad`` off on its MVM teacher, which then gets no gradient;
  :func:`build_optimizer` does so for every teacher module that the JAX
  ``_is_frozen`` names, and passes the parameters under the run's
  ``freeze`` prefixes as ``frozen``. Those keep their gradients, and the
  clip counts them: the JAX clip runs before the labels split the tree, so
  it counts them too (the PyTorch reference computes none; a teacher's
  gradient, run under no_grad, is zero on both sides).

* Accumulation (``grad_accum`` k > 1): ``optax.MultiSteps(every_k_schedule=k)``
  around all of the above. Each micro-step folds its gradient into a running
  mean, ``acc + (g - acc) / (n + 1)`` (optax's Welford update); the k-th
  runs the clip and AdamW on the mean and resets it. The parameters do not
  move in between, and the inner ``count`` (the schedule's step and the bias
  corrections) advances once every k micro-steps, while ``max_iter`` stays
  the run's count of micro-steps, as the JAX agent passes it: the schedule
  then reaches only 1/k of its length, as in the JAX package.

Parameters and moments are updated in place (``torch._foreach_*`` over each
group), which saves a copy of both; a trained parameter that received no
gradient is updated as with a zero gradient, as under ``jax.grad``. Under
FSDP (``parallel.mesh.shard_model``) parameters, gradients and moments are
DTensor shards: the update runs on each rank's local shards, and the clip's
norm sums the shards' squares over the ranks.
"""

from __future__ import annotations

import re
from typing import Callable, Iterable

import torch
import torch.distributed as dist
from torch import nn

from empirical_mvm_torch.core.config import TrainConfig
from empirical_mvm_torch.models.common import BatchNorm2d
from empirical_mvm_torch.ops.layernorm import LayerNorm
from empirical_mvm_torch.parallel.mesh import local_tensor

GROUPS = ("swin_decay", "swin_nodecay", "other_decay", "other_nodecay")
FROZEN = "frozen"
EPS = 1e-8          # Adam's epsilon in the JAX build_optimizer

# Frozen-teacher modules, excluded from updates wherever they sit in the
# model (the JAX ``TEACHER_PREFIXES``; ref: main_pretrain.py:515-545 runs the
# MVM teachers under no_grad).
TEACHER_PREFIXES = ("feature_model", "dpt", "raft", "dvae", "clip_model")


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


def group_labels(model: nn.Module, frozen: Iterable[str] = ()) -> dict[str, str]:
    """Parameter name -> group, by the rule of ``default_group_fn``, or
    ``frozen`` where ``requires_grad`` is off or the name is in ``frozen``."""
    frozen = set(frozen)
    norm_weights = {id(m.weight) for m in model.modules()
                    if isinstance(m, (LayerNorm, BatchNorm2d))}
    labels = {}
    for name, p in model.named_parameters():
        if not p.requires_grad or name in frozen:
            labels[name] = FROZEN
            continue
        no_decay = "bias" in name.rsplit(".", 1)[-1] or id(p) in norm_weights
        labels[name] = (f"{'swin' if 'swin' in name else 'other'}_"
                        f"{'nodecay' if no_decay else 'decay'}")
    return labels


def port_path(prefix: str) -> str:
    """A JAX tree path (``trsfr.layer_0``, ``enc_img.swin.layers_2``) in the
    port's parameter names, whose list entries are ``name.i``
    (``trsfr.layer.0``); the top-level modules keep their names."""
    return re.sub(r"_(\d+)(?=\.|$)", r".\1", prefix)


def _is_frozen(name: str, freeze_prefixes: tuple[str, ...]) -> bool:
    """The JAX ``_is_frozen``: under a ``freeze`` prefix (path-prefix match),
    or inside a teacher module anywhere in the model."""
    for pre in freeze_prefixes:
        if name == pre or name.startswith(pre + "."):
            return True
    return any(name == mod or name.startswith(mod + ".") or f".{mod}." in name
               for mod in TEACHER_PREFIXES)


def _global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """The l2 norm of every element of ``tensors``: the norm of the norms,
    or with sharded tensors the square root of the squares summed over the
    ranks' shards plus those of the replicated ones."""
    sharded = [t for t in tensors if local_tensor(t) is not t]
    if not sharded:
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))
    plain = [t for t in tensors if local_tensor(t) is t]
    sq = torch.stack(torch._foreach_norm([local_tensor(t) for t in sharded])).square().sum()
    dist.all_reduce(sq, group=sharded[0].device_mesh.get_group())
    if plain:
        sq = sq + torch.stack(torch._foreach_norm(plain)).square().sum()
    return sq.sqrt()


class AdamW:
    """The optimizer of ``build_optimizer`` over a model's parameters.

    ``init(params)`` returns the state (step count and both moments of
    every parameter that is not frozen; with ``grad_accum`` > 1 also the
    micro-step and the running mean of every parameter's gradient);
    ``update(params, grads, state)`` clips, updates moments and parameters
    in place and returns the state.
    """

    def __init__(self, model: nn.Module, lr: float, max_iter: int,
                 weight_decay: float = 1e-3, betas: tuple[float, float] = (0.9, 0.98),
                 warmup_ratio: float = 0.1, min_lr: float = 1e-8,
                 max_grad_norm: float = 1.0, backbone_lr_mul: float = 1.0,
                 frozen: Iterable[str] = (), grad_accum: int = 1):
        self.labels = group_labels(model, frozen)
        self.grad_accum = grad_accum
        self.betas, self.max_grad_norm = betas, max_grad_norm
        mul = {"swin": backbone_lr_mul, "other": 1.0}
        self.schedules = {g: warmup_linear_schedule(lr * mul[g.split("_")[0]], max_iter,
                                                    warmup_ratio, min_lr) for g in GROUPS}
        self.weight_decay = {g: (weight_decay if g.endswith("_decay") else 0.0)
                             for g in GROUPS}

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        trained = {n: p for n, p in params.items() if self.labels[n] != FROZEN}
        state = {"count": 0,
                 "mu": {n: torch.zeros_like(p) for n, p in trained.items()},
                 "nu": {n: torch.zeros_like(p) for n, p in trained.items()}}
        if self.grad_accum > 1:
            state["mini_step"] = 0
            state["acc"] = {n: torch.zeros_like(p) for n, p in params.items()
                            if p.requires_grad}
        return state

    @torch.no_grad()
    def update(self, params: dict[str, torch.Tensor],
               grads: dict[str, torch.Tensor | None], state: dict) -> dict:
        if self.grad_accum == 1:
            return self._apply(params, grads, state)
        n = state["mini_step"]
        acc = state["acc"]
        for name, a in acc.items():         # optax MultiSteps' running mean
            a = local_tensor(a)
            g = torch.zeros_like(a) if grads[name] is None else local_tensor(grads[name])
            a.add_(torch.sub(g, a).div_(n + 1))
        if n == self.grad_accum - 1:
            self._apply(params, {k: acc.get(k) for k in params}, state)
            torch._foreach_zero_([local_tensor(a) for a in acc.values()])
        state["mini_step"] = (n + 1) % self.grad_accum
        return state

    def _apply(self, params, grads, state: dict) -> dict:
        """One clip + AdamW update (the inner transformation)."""
        names = [n for n in params if self.labels[n] != FROZEN]
        g = [grads[n] if grads[n] is not None else torch.zeros_like(params[n])
             for n in names]
        if self.max_grad_norm > 0:
            counted = g + [grads[n] for n in params
                           if self.labels[n] == FROZEN and grads[n] is not None]
            norm = _global_norm(counted)
            factor = torch.where(norm < self.max_grad_norm, torch.ones_like(norm),
                                 self.max_grad_norm / norm)
            g = torch._foreach_mul([local_tensor(x) for x in g], factor)
        else:
            g = [local_tensor(x) for x in g]
        count = state["count"] + 1
        b1, b2 = self.betas
        bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
        for group in GROUPS:
            idx = [i for i, n in enumerate(names) if self.labels[n] == group]
            if not idx:
                continue
            p = [local_tensor(params[names[i]]) for i in idx]
            gg = [g[i] for i in idx]
            mu = [local_tensor(state["mu"][names[i]]) for i in idx]
            nu = [local_tensor(state["nu"][names[i]]) for i in idx]
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


def build_optimizer(model: nn.Module, train_cfg: TrainConfig, max_iter: int) -> AdamW:
    """The JAX ``build_optimizer`` as ``AgentBase`` calls it: the run's lr,
    decay, betas, schedule, clip and backbone multiplier, and frozen the
    parameters that ``_is_frozen`` names: the teachers with
    ``requires_grad_(False)`` on ``model`` itself, the run's ``freeze``
    prefixes (given as JAX tree paths) by name, their gradients still
    counted by the clip; with ``grad_accum`` > 1 wrapped as
    ``optax.MultiSteps``."""
    t = train_cfg
    prefixes = tuple(port_path(p) for p in t.freeze)
    frozen = []
    for name, p in model.named_parameters():
        if _is_frozen(name, ()):
            p.requires_grad_(False)
        elif _is_frozen(name, prefixes):
            frozen.append(name)
    return AdamW(model, t.lr, max_iter, weight_decay=t.decay, betas=t.betas,
                 warmup_ratio=t.warmup_ratio, min_lr=t.min_lr, max_grad_norm=t.max_grad_norm,
                 backbone_lr_mul=t.vis_backbone_lr_mul, frozen=frozen,
                 grad_accum=t.grad_accum)
