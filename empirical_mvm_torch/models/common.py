"""Pieces the port's models share."""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from empirical_mvm_torch.ops.layernorm import LayerNorm


class Linear(nn.Linear):
    """``nn.Linear`` whose fp32 parameters are cast to a compute dtype at use,
    with the input: the cast structure of flax ``nn.Dense(dtype=...)`` in the
    JAX package (parameters stay fp32, products run in the model dtype)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` on channel-last input (B, H, W, C) -> (B, H', W', O),
    fp32 parameters cast to a compute dtype at use with the input (flax
    ``nn.Conv(dtype=...)``). The permuted views are channels-last NCHW
    tensors, which cuDNN convolves as they lie. ``padding`` is symmetric, as
    torch pads."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1,
                 padding=0, bias: bool = True, compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), b, self.stride,
                     self.padding)
        return y.permute(0, 2, 3, 1)


def dropout(x: torch.Tensor, p: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout drawn from ``generator`` (flax ``nn.Dropout``: keep
    with probability 1 - p, kept values divided by 1 - p in x's dtype). No
    generator, or p = 0, is the deterministic pass: x unchanged."""
    if generator is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), x.new_zeros(()))


def init_weights(module: nn.Module, generator: torch.Generator,
                 std: float = 0.02) -> None:
    """Seeded random init of every parameter: LayerNorm weights 1, biases 0,
    everything else N(0, std). The port's models are built for tests and
    chip runs from random weights, or load converted checkpoints."""
    norms = {id(m.weight) for m in module.modules() if isinstance(m, LayerNorm)}
    with torch.no_grad():
        for name, p in module.named_parameters():
            if id(p) in norms:
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, std, generator=generator)


def remat(fn, generator: torch.Generator | None, *args):
    """``fn(*args, generator)`` with its activations recomputed in the
    backward (``torch.utils.checkpoint``, non-reentrant; JAX ``nn.remat``).

    Dropout, drop path and the kernels' Philox seeds draw from the explicit
    ``generator``, which checkpoint's ``preserve_rng_state`` does not cover:
    the recompute starts it from its state at the block's entry, so it draws
    the same masks, and puts it back afterwards, so that the generator ends
    the step where the pass without remat leaves it."""
    if not torch.is_grad_enabled():
        return fn(*args, generator)
    entry = None if generator is None else generator.get_state()
    first = [True]

    def run(*a):
        if first[0] or generator is None:   # the forward: draws as without remat
            first[0] = False
            return fn(*a, generator)
        after = generator.get_state()
        generator.set_state(entry)
        try:
            return fn(*a, generator)
        finally:
            generator.set_state(after)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)
