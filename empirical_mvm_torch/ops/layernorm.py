"""LayerNorm: the fused CUDA kernels, their plain PyTorch versions, and modules.

Counterpart of ``empirical_mvm_tpu/ops/layernorm.py``. The kernels
(``csrc/layer_norm.cu``) replace the Pallas ``_ln_fwd_kernel`` and
``_ln_bwd_kernel``; :func:`fused_layer_norm` is a ``torch.autograd.Function``
over them and runs the BERT/fusion LayerNorms, the MLM head's and the
``EncVideo`` norm. The trained video swin keeps a plain LayerNorm with plain
autograd, as the JAX package keeps flax ``nn.LayerNorm`` there
(``LayerNorm`` below).

Numerics of both versions: fp32 mean and two-pass variance, fp32 affine
transform with fp32 gamma/beta, output in the input's dtype. The backward
recomputes mean and rstd from x.

The kernels have two bodies, picked by dtype and C in their C entry points
and mirrored by :func:`_ln_body`: the vectorized body at the widths the
paths run (``VECTOR_WIDTHS``: the row read once in 16-byte vectors and kept
in registers), the scalar body of the first slices at any other C.
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


def layer_norm_backward_reference(x: torch.Tensor, weight: torch.Tensor,
                                  dy: torch.Tensor, eps: float):
    """Plain backward with the kernel's algebra (JAX ``_ln_bwd_kernel``):
    recompute mean and rstd, then with xhat = (x - mean) * rstd and
    dxhat = dy * gamma,
    ``dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))``;
    dgamma = sum(dy * xhat), dbeta = sum(dy) over all rows, fp32.
    Returns dx in x's dtype, dgamma, dbeta."""
    c = x.shape[-1]
    xf = x.float().reshape(-1, c)
    dyf = dy.float().reshape(-1, c)
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xhat = xc * rstd
    dxhat = dyf * weight.float()
    m1 = dxhat.sum(-1, keepdim=True) / c
    m2 = (dxhat * xhat).sum(-1, keepdim=True) / c
    dx = rstd * (dxhat - m1 - xhat * m2)
    return (dx.reshape(x.shape).to(x.dtype), (dyf * xhat).sum(0), dyf.sum(0))


# widths the vectorized body is instantiated for (csrc/layer_norm.cu
# `with_vec_shape`): every LayerNorm site of the paths (BERT and CLIP 768,
# the 2D and 3D teachers' stages 128-1024 and merges 512-2048; fp32 for the
# text embeddings). The backward, whose sites are all 768, stops at 1024: at
# 2048 a lane's share of x, dy, dgamma and dbeta does not fit in registers.
VECTOR_WIDTHS = {torch.bfloat16: (128, 256, 512, 768, 1024, 2048), torch.float32: (768,)}
VECTOR_BWD_WIDTHS = {torch.bfloat16: (128, 256, 512, 768, 1024), torch.float32: (768,)}


def _ln_body(dtype: torch.dtype, c: int, backward: bool = False) -> str:
    """The body a launch over rows of ``c`` values of ``dtype`` runs, by the
    rule of the C entry points: ``vectorized`` at ``VECTOR_WIDTHS`` (the
    backward at ``VECTOR_BWD_WIDTHS``; with 16-byte aligned pointers, as
    every tensor the paths pass: a view at another offset takes the scalar
    body), ``scalar`` at any other C."""
    widths = VECTOR_BWD_WIDTHS if backward else VECTOR_WIDTHS
    return "vectorized" if c in widths.get(dtype, ()) else "scalar"


def _ln_fwd(x, weight, bias, eps):
    if weight.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("fused_layer_norm takes float32 weight and bias")
    dev = _build.check_tensors(x, weight, bias)
    code = _build.dtype_code(x.dtype)
    y = torch.empty_like(x)
    c = x.shape[-1]
    rows = x.numel() // c
    if rows == 0:
        return y
    lib = _build.library()
    with _build.on_device(dev):
        _build.record_launch(lib.emvm_layer_norm_fwd(
            code, x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            rows, c, float(eps), _build.stream_ptr(dev)), "fused_layer_norm")
    return y


def _ln_bwd(x, weight, dy, eps):
    dev = _build.check_tensors(x, weight, dy)
    if dy.dtype != x.dtype:
        raise TypeError(f"dy is {dy.dtype}, x {x.dtype}")
    code = _build.dtype_code(x.dtype)
    c = x.shape[-1]
    rows = x.numel() // c
    dx = torch.empty_like(x)
    if rows == 0:
        dgb = torch.zeros((2, c), dtype=torch.float32, device=dev)
        return dx, dgb[0], dgb[1]
    lib = _build.library()
    _build.check_smem(lib.emvm_layer_norm_bwd_smem_bytes(code, c),
                      f"the LayerNorm backward over C={c}")
    dgb = torch.empty((2, c), dtype=torch.float32, device=dev)
    part = torch.empty(lib.emvm_layer_norm_bwd_scratch(rows, c), dtype=torch.float32,
                       device=dev)
    with _build.on_device(dev):
        _build.record_launch(lib.emvm_layer_norm_bwd(
            code, x.data_ptr(), weight.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dgb.data_ptr(), part.data_ptr(), rows, c, float(eps), _build.stream_ptr(dev)),
            "fused_layer_norm_bwd")
    return dx, dgb[0], dgb[1]


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        if x.device.type == "cpu":
            return layer_norm_reference(x, weight, bias, eps)
        return _ln_fwd(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, dg, db = layer_norm_backward_reference(x, weight, dy, ctx.eps)
        else:
            dx, dg, db = _ln_bwd(x, weight, dy.contiguous(), ctx.eps)
        return dx, dg, db, None


def fused_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, differentiable in x, weight and bias.
    x (..., C) float32 or bfloat16; weight, bias (C,) float32. Returns x's
    dtype.

    A CPU tensor takes the plain versions; a CUDA tensor launches the
    kernels.
    """
    c = x.shape[-1]
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"weight/bias must be ({c},), got {tuple(weight.shape)}"
                         f" and {tuple(bias.shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _FusedLayerNorm.apply(x, weight, bias, float(eps))
    # nothing to differentiate (the frozen teachers, the evals): the same
    # call without the autograd node, whose host time the small sites feel
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, eps)
    return _ln_fwd(x, weight, bias, float(eps))


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
