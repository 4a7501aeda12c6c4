"""The pretrain train step (counterpart of
``empirical_mvm_tpu/train/train_step.py``, single device): masking,
forward, every loss, backward and the AdamW update of one step.

PyTorch runs eagerly, so the step is a plain function over a
:class:`TrainState`. Its parameters are the model's own and are updated in
place, as are the optimizer's moments.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch import nn

from empirical_mvm_torch.train.optimizer import AdamW


@dataclass
class TrainState:
    params: dict[str, nn.Parameter]
    opt_state: dict
    step: int


def create_train_state(model: nn.Module, optimizer: AdamW) -> TrainState:
    params = dict(model.named_parameters())
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def step_generators(seed: int, step: int, device) -> tuple[torch.Generator, torch.Generator]:
    """The (dropout, mask) generators of one step, from (seed, step): the
    roles of ``fold_in(rng, step)`` and ``split`` in the JAX step."""
    words = np.random.SeedSequence([seed, step]).generate_state(4, dtype=np.uint32)
    return tuple(torch.Generator(device).manual_seed(int(words[2 * i]) << 32 | int(words[2 * i + 1]))
                 for i in range(2))


def make_pretrain_train_step(model: nn.Module, optimizer: AdamW) -> Callable:
    """Build ``step(state, batch, seed) -> (state, losses)``.

    ``batch``: img (B, T, H, W, 3) uint8 or normalized float, unmasked; txt
    (B, X) int; mask (B, X) int. Optional ``draws`` (a ``MaskDraws``) and
    ``neg_idx`` replace the step's own mask and negative draws. The losses
    are detached device tensors (reading them waits for the step).
    """
    device = next(model.parameters()).device

    def step(state: TrainState, batch: dict, seed: int):
        drop_gen, mask_gen = step_generators(seed, state.step, device)
        for p in state.params.values():
            p.grad = None
        ls = model.losses(batch["img"], batch["txt"], batch["mask"], generator=drop_gen,
                          mask_generator=mask_gen, draws=batch.get("draws"),
                          neg_idx=batch.get("neg_idx"))
        ls["total"].backward()
        opt_state = optimizer.update(state.params,
                                     {n: p.grad for n, p in state.params.items()},
                                     state.opt_state)
        return (TrainState(state.params, opt_state, state.step + 1),
                {k: v.detach() for k, v in ls.items()})

    return step
