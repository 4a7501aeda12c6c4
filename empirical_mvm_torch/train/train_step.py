"""The train steps (counterpart of ``empirical_mvm_tpu/train/train_step.py``
and of the supervised agents' step in ``train/agent.py``): the pretrain step
(masking, forward, every loss, backward and the AdamW update), the
supervised fine-tune step of the downstream heads, and the deterministic
eval forward.

PyTorch runs eagerly, so the step is a plain function over a
:class:`TrainState`. Its parameters are the model's own and are updated in
place, as are the optimizer's moments.

Given a ``dp`` (``parallel.mesh.DataParallel``), a step runs on this rank's
rows of the global batch under ``data_parallel(dp)``: each rank's losses
are its shares of the global batch's, the replicated gradients are summed
over the ranks after backward (the sharded ones by their reduce-scatter),
every rank applies the same update, and the returned losses are the global
ones. ``state.step`` counts micro-steps (the generators' fold-in), and the
optimizer accumulates ``grad_accum`` of them into one update.

A step opens the tracer's spans (``core/tracing.py``): ``step`` around it,
its request id ``state.step``, and in it ``step.forward`` (the model's
forward and losses), ``step.backward`` and ``step.update``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
from torch import nn

from empirical_mvm_torch.core import tracing
from empirical_mvm_torch.models.common import bn_buffers, fold_bn_stats
from empirical_mvm_torch.parallel.mesh import (DataParallel, data_parallel, reduce_gradients,
                                               reduce_losses)
from empirical_mvm_torch.train.losses import (cross_entropy_ignore, label_smoothed_nll,
                                              norm_softmax_loss)
from empirical_mvm_torch.train.optimizer import AdamW


@dataclass
class TrainState:
    params: dict[str, nn.Parameter]
    opt_state: dict
    step: int
    # the running statistics of train-mode BatchNorms (by state_dict name):
    # the steps fold into them in place, a resumable checkpoint keeps them
    buffers: dict[str, torch.Tensor] = field(default_factory=dict)


def create_train_state(model: nn.Module, optimizer: AdamW) -> TrainState:
    params = dict(model.named_parameters())
    return TrainState(params=params, opt_state=optimizer.init(params), step=0,
                      buffers=bn_buffers(model))


def step_generators(seed: int, step: int, device) -> tuple[torch.Generator, torch.Generator]:
    """The (dropout, mask) generators of one step, from (seed, step): the
    roles of ``fold_in(rng, step)`` and ``split`` in the JAX step."""
    words = np.random.SeedSequence([seed, step]).generate_state(4, dtype=np.uint32)
    return tuple(torch.Generator(device).manual_seed(int(words[2 * i]) << 32 | int(words[2 * i + 1]))
                 for i in range(2))


def _update(model: nn.Module, optimizer: AdamW, state: TrainState,
            dp: DataParallel | None) -> TrainState:
    """The update after backward, then the train-mode BatchNorms' batch
    statistics folded into their running ones (JAX: ``fold_bn_stats`` after
    ``apply_updates``, every micro-step): the span ``step.update``."""
    with tracing.span("step.update"):
        reduce_gradients(state.params.values(), dp)
        opt_state = optimizer.update(state.params, {n: p.grad for n, p in state.params.items()},
                                     state.opt_state)
        if state.buffers:
            fold_bn_stats(model)
    return TrainState(state.params, opt_state, state.step + 1, state.buffers)


def make_pretrain_train_step(model: nn.Module, optimizer: AdamW,
                             dp: DataParallel | None = None) -> Callable:
    """Build ``step(state, batch, seed) -> (state, losses)``.

    ``batch``: img (B, T, H, W, 3) uint8 or normalized float, unmasked; txt
    (B, X) int; mask (B, X) int. Optional ``draws`` (a ``MaskDraws``) and
    ``neg_idx`` replace the step's own mask and negative draws, ``hog``
    (B, T, H, W) the hog target the model would compute (as the JAX step
    reads ``batch.get("hog")``), and ``vq`` is the vq target's tokens (the
    JAX step's ``batch.get("vq")``; see ``VioletPretrain.losses``), and
    ``corrupt`` (B,) bool the loader's flag of clips to zero (as the JAX
    step reads ``batch.get("corrupt")``). The losses are detached device
    tensors (reading them waits for the step).
    """
    device = next(model.parameters()).device

    def step(state: TrainState, batch: dict, seed: int):
        tracing.request(state.step)
        with tracing.span("step"):
            drop_gen, mask_gen = step_generators(seed, state.step, device)
            for p in state.params.values():
                p.grad = None
            with tracing.span("step.forward"), data_parallel(dp):
                ls = model.losses(batch["img"], batch["txt"], batch["mask"], generator=drop_gen,
                                  mask_generator=mask_gen, draws=batch.get("draws"),
                                  neg_idx=batch.get("neg_idx"), hog=batch.get("hog"),
                                  vq=batch.get("vq"), corrupt=batch.get("corrupt"))
            with tracing.span("step.backward"):
                ls["total"].backward()
            return _update(model, optimizer, state, dp), reduce_losses(ls, dp)

    return step


def make_supervised_train_step(model: nn.Module, optimizer: AdamW, loss_kind: str = "ce",
                               temp: float = 0.05, dp: DataParallel | None = None) -> Callable:
    """Build ``step(state, batch, seed) -> (state, {"total": loss})``, the
    JAX ``make_supervised_agent(loss_kind)`` step (``train/agent.py:360-416``):
    the model's training pass ``model(img, txt, mask)`` with dropout drawn
    from the step's generator, the loss, backward and the update.

    * ``"ce"`` (``QAMCAgent``, ``QAOEAgent``): logits (B, K) against
      ``batch["ans"]`` (B,), label -1 ignored.
    * ``"nce"`` (``RetrievalAgent``): the (B, B) scores through
      ``norm_softmax_loss`` at temperature ``temp`` (the run's
      ``train.temp``).
    * ``"mlm"`` (``QAMCGenAgent``, ``QAOEMLMAgent``): MLM logits (..., X, V)
      against ``batch["mask_ans"]`` (..., X), -1 ignored.
    * ``"caption"`` (``CaptionAgent``, JAX ``cli/caption.py:62-91``): the
      seq2seq MLM logits (B, X, V) against ``batch["mask_ans"]`` through
      ``label_smoothed_nll``.

    ``batch`` holds img, txt, mask and the loss's labels on the model's
    device; an optional ``gumbel_noise`` replaces the gumbel draws of
    ``VioletQAMC``'s video-token selection (as ``draws`` replaces the
    pretrain step's masks)."""
    if loss_kind not in ("ce", "nce", "mlm", "caption"):
        raise ValueError(f"unknown loss_kind {loss_kind!r}")
    device = next(model.parameters()).device

    def loss_fn(out, batch):
        if loss_kind == "nce":
            return norm_softmax_loss(out, temp)
        if loss_kind == "caption":
            return label_smoothed_nll(out, batch["mask_ans"])
        return cross_entropy_ignore(out, batch["mask_ans" if loss_kind == "mlm" else "ans"])

    def step(state: TrainState, batch: dict, seed: int):
        tracing.request(state.step)
        with tracing.span("step"):
            drop_gen, _ = step_generators(seed, state.step, device)
            for p in state.params.values():
                p.grad = None
            extra = {"gumbel_noise": batch["gumbel_noise"]} if "gumbel_noise" in batch else {}
            with tracing.span("step.forward"), data_parallel(dp):
                loss = loss_fn(model(batch["img"], batch["txt"], batch["mask"],
                                     generator=drop_gen, **extra), batch)
            with tracing.span("step.backward"):
                loss.backward()
            return _update(model, optimizer, state, dp), reduce_losses({"total": loss}, dp)

    return step


def make_eval_step(model: nn.Module, dp: DataParallel | None = None) -> Callable:
    """Build ``eval_step(batch)``: the deterministic forward of
    ``model(img, txt, mask)`` without autograd (JAX ``make_eval_step``),
    on this rank's rows of the global batch under ``data_parallel(dp)``."""

    @torch.no_grad()
    def eval_step(batch: dict):
        with data_parallel(dp):
            return model(batch["img"], batch["txt"], batch["mask"])

    return eval_step
