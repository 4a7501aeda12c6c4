"""LayerNorm: the fused CUDA kernel, its plain PyTorch version, and modules.

Counterpart of ``empirical_mvm_tpu/ops/layernorm.py`` (forward only). The
kernel (``csrc/layer_norm.cu``) replaces the Pallas ``_ln_fwd_kernel``; it
runs the BERT/fusion LayerNorms and the ``EncVideo`` norm. The trained video
swin keeps a plain LayerNorm, as the JAX package does (``LayerNorm`` below).

Numerics of both versions: fp32 mean and two-pass variance, fp32 affine
transform with fp32 gamma/beta, output in the input's dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from empirical_mvm_torch.ops import _build


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain version (JAX ``layer_norm_reference``)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(x.dtype)


def fused_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis. x (..., C) float32 or bfloat16;
    weight, bias (C,) float32. Returns x's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    c = x.shape[-1]
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"weight/bias must be ({c},), got {tuple(weight.shape)}"
                         f" and {tuple(bias.shape)}")
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, eps)
    if weight.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("fused_layer_norm takes float32 weight and bias")
    dev = _build.check_tensors(x, weight, bias)
    code = _build.dtype_code(x.dtype)
    y = torch.empty_like(x)
    rows = x.numel() // c
    if rows == 0:
        return y
    lib = _build.library()
    with torch.cuda.device(dev):
        _build.record_launch(lib.emvm_layer_norm_fwd(
            code, x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            rows, c, float(eps), _build.stream_ptr(dev)), "fused_layer_norm")
    return y


class LayerNorm(nn.Module):
    """Plain LayerNorm with ``weight``/``bias`` (torch checkpoint names).
    Used by the trained video swin, where the JAX package keeps flax
    ``nn.LayerNorm`` rather than its kernel."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_reference(x, self.weight, self.bias, self.eps)


class FusedLayerNorm(LayerNorm):
    """The same parameters, through :func:`fused_layer_norm` (JAX
    ``FusedLayerNorm``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_layer_norm(x, self.weight, self.bias, self.eps)
