"""Pieces the port's models share."""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from empirical_mvm_torch.ops.layernorm import LayerNorm
from empirical_mvm_torch.parallel.mesh import all_reduce_sum, global_rows


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


class BatchNorm2d(nn.Module):
    """torch ``BatchNorm2d`` on channel-last maps (JAX ``BatchNorm2d``),
    fp32 arithmetic, output fp32 as JAX's ``xf`` gives.

    Eval mode: ``(x - running_mean) * rsqrt(running_var + eps) * weight +
    bias``. Train mode (``use_batch_stats``): the batch mean and biased
    variance per channel over (N, H, W), two passes as ``jnp.var``. Under
    ``data_parallel`` the sums are over every rank's rows (a
    differentiable all-reduce of the sum, then of the centred squares; the
    count is this rank's times the ranks', the port's batches being even),
    so every rank normalizes by the global batch's statistics, as the JAX
    mesh does. The detached mean and unbiased variance wait in
    ``batch_stats`` for :func:`fold_bn_stats`."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.batch_stats: tuple[torch.Tensor, torch.Tensor] | None = None

    def forward(self, x: torch.Tensor, use_batch_stats: bool = False) -> torch.Tensor:
        xf = x.float()
        if use_batch_stats:
            flat = xf.reshape(-1, xf.shape[-1])
            n = global_rows(flat.shape[0])
            mean = all_reduce_sum(flat.sum(0)) / n
            var = all_reduce_sum((flat - mean).square().sum(0)) / n
            self.batch_stats = (mean.detach(), var.detach() * (n / max(n - 1, 1)))
        else:
            mean, var = self.running_mean, self.running_var
        return (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


BN_MOMENTUM = 0.1   # torch nn.BatchNorm2d's default, torchvision's R50's


@torch.no_grad()
def fold_bn_stats(model: nn.Module, momentum: float = BN_MOMENTUM) -> None:
    """Fold each train-mode :class:`BatchNorm2d`'s pending batch statistics
    into its running ones, ``running = (1 - m) * running + m * batch`` (torch
    semantics; JAX ``fold_bn_stats``), and clear them; the train steps call
    it after the update. No-op where no BN ran in train mode."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d) and m.batch_stats is not None:
            for run, new in zip((m.running_mean, m.running_var), m.batch_stats):
                run.copy_((1.0 - momentum) * run + momentum * new)
            m.batch_stats = None


def bn_buffers(model: nn.Module) -> dict[str, torch.Tensor]:
    """The running statistics of ``model``'s :class:`BatchNorm2d` modules by
    ``state_dict`` name: the state a train step changes besides the
    parameters and the optimizer's."""
    return {f"{name}.{leaf}": getattr(m, leaf) for name, m in model.named_modules()
            if isinstance(m, BatchNorm2d) for leaf in ("running_mean", "running_var")}


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
    """Seeded random init of every parameter: LayerNorm and BatchNorm
    weights 1, biases 0, everything else N(0, std). The port's models are
    built for tests and chip runs from random weights, or load converted
    checkpoints."""
    norms = {id(m.weight) for m in module.modules() if isinstance(m, (LayerNorm, BatchNorm2d))}
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
