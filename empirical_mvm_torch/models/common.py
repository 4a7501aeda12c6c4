"""Pieces the port's models share."""

from __future__ import annotations

import torch
import torch.nn.functional as F
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
