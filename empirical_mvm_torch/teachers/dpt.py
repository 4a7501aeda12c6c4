"""Frozen MiDaS DPT-Large monocular depth teacher, the teacher of the
``depth`` MVM target (counterpart of ``empirical_mvm_tpu/teachers/dpt.py``;
ref: visbackbone/midas/dpt_depth.py:26-110, vit.py:56-270, blocks.py:49-76,
231-345; main_pretrain.py:189-193, 433-452).

A ViT-L/16 backbone whose block outputs after blocks ``hooks`` (5, 11, 17,
23) are reassembled at strides 4 / 8 / 16 / 32 (a 'project' readout, a 1x1
conv and a resample), brought to ``features`` channels and fused by four
RefineNet blocks into a depth map at the input's size. Channel-last, as in
the JAX package, with the convolutions through :class:`Conv2d`.

The parameters carry the MiDaS checkpoint's names (``pretrained.model.
blocks.{i}.attn.qkv``, ``pretrained.act_postprocess{n}.{0,3,4}``,
``scratch.refinenet{n}``, ``scratch.output_conv.{0,2,4}``), so a MiDaS
state_dict loads as it is, but for ``scratch.refinenet4.resConfUnit1``,
which the forward never runs and the port does not hold (nor does the JAX
tree), and the JAX ``dpt_params_from_torch`` reads the port's state_dict.

As in the JAX package (the frozen-teacher policy): each block's
LayerNorms through the kernel (:class:`FusedLayerNorm`, eps 1e-6), its
attention through :func:`vit_self_attention` (``lane_self_attention`` at
ViT-L's 197 tokens of width 1024), exact GELU; the position embedding
resized bilinearly from the ``train_grid`` to the input grid as
``jax.image.resize`` resizes it (antialiased where it shrinks, 24^2 -> 14^2
at 224^2); the reassemble upsamplers as the JAX ``nn.ConvTranspose`` with
the imported kernel computes them, which is torch's transposed convolution
with the kernel flipped in both spatial axes; the head's last conv in fp32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from empirical_mvm_torch.models.common import Conv2d, Linear
from empirical_mvm_torch.ops.layernorm import FusedLayerNorm
from empirical_mvm_torch.ops.window_attention import vit_self_attention


def interp2x(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 2H, 2W, C): bilinear with ``align_corners=True``
    (the JAX ``_interp2x``; ref: blocks.py Interpolate)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                      align_corners=True)
    return y.permute(0, 2, 3, 1)


def resize_pos_embed(pos: torch.Tensor, train_grid: int, gh: int, gw: int) -> torch.Tensor:
    """(1, 1 + g*g, D) -> (1, 1 + gh*gw, D): the class token's entry kept,
    the grid's resized as ``jax.image.resize(..., "bilinear")`` resizes it:
    half-pixel centres, and a triangle kernel widened by the scale where it
    shrinks (``antialias=True``; without it 24 -> 14 reads 1.6 off)."""
    d = pos.shape[-1]
    grid = pos[:, 1:].reshape(1, train_grid, train_grid, d).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(gh, gw), mode="bilinear", align_corners=False,
                         antialias=True)
    return torch.cat([pos[:, :1], grid.permute(0, 2, 3, 1).reshape(1, gh * gw, d)], dim=1)


class ViTBlock(nn.Module):
    """timm ``Block`` (norm1 -> attention -> residual, norm2 -> MLP ->
    residual) on the frozen-teacher path (the JAX ``ViTBlock(use_pallas=
    True)``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = FusedLayerNorm(dim, 1e-6)
        self.attn = nn.Module()
        self.attn.qkv = Linear(dim, 3 * dim, compute_dtype=dtype)
        self.attn.proj = Linear(dim, dim, compute_dtype=dtype)
        self.norm2 = FusedLayerNorm(dim, 1e-6)
        self.mlp = nn.Module()
        self.mlp.fc1 = Linear(dim, int(dim * mlp_ratio), compute_dtype=dtype)
        self.mlp.fc2 = Linear(int(dim * mlp_ratio), dim, compute_dtype=dtype)

    def forward(self, x):
        ctx = vit_self_attention(self.attn.qkv(self.norm1(x)), self.num_heads)
        x = x + self.attn.proj(ctx)
        return x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))


class ResidualConvUnit(nn.Module):
    """relu -> conv 3x3 -> relu -> conv 3x3, plus the input (ref:
    blocks.py:231-287, bn=False)."""

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, padding=1, compute_dtype=dtype)
        self.conv2 = Conv2d(features, features, 3, padding=1, compute_dtype=dtype)

    def forward(self, x):
        return self.conv2(torch.relu(self.conv1(torch.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    """(ref: blocks.py:291-345, align_corners=True): the skip input through
    ``resConfUnit1`` (which ``skip=False``, refinenet4's case, does not
    hold), ``resConfUnit2``, the 2x upsample, the 1x1 ``out_conv``."""

    def __init__(self, features: int, skip: bool = True, dtype=torch.float32):
        super().__init__()
        if skip:
            self.resConfUnit1 = ResidualConvUnit(features, dtype)
        self.resConfUnit2 = ResidualConvUnit(features, dtype)
        self.out_conv = Conv2d(features, features, 1, compute_dtype=dtype)

    def forward(self, x0, x1=None):
        out = x0 if x1 is None else x0 + self.resConfUnit1(x1)
        return self.out_conv(interp2x(self.resConfUnit2(out)))


class UpConv(nn.ConvTranspose2d):
    """The JAX reassemble upsampler, ``nn.ConvTranspose(k, strides=k)`` with
    a kernel imported unflipped from the torch (in, out, kh, kw) weight:
    flax convolves the stride-dilated input without flipping, so each input
    pixel's k x k output block is the torch kernel turned by 180 degrees.
    Channel-last, products in ``compute_dtype``."""

    def __init__(self, channels: int, k: int, compute_dtype=torch.float32):
        super().__init__(channels, channels, k, k)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        y = F.conv_transpose2d(x.to(dt).permute(0, 3, 1, 2),
                               self.weight.to(dt).flip(2, 3), self.bias.to(dt), self.stride)
        return y.permute(0, 2, 3, 1)


class ProjectReadout(nn.Module):
    """(ref: vit.py ProjectReadout): each patch token concatenated with the
    class token, then Linear(2D, D) and exact GELU."""

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.project = nn.Sequential(Linear(2 * dim, dim, compute_dtype=dtype), nn.GELU())

    def forward(self, t):
        readout = t[:, :1].expand(-1, t.shape[1] - 1, -1)
        return self.project(torch.cat([t[:, 1:], readout], dim=-1))


class DPTDepth(nn.Module):
    """DPT-Large depth model (the JAX ``DPTDepth``; ref: dpt_depth.py:88-110).
    Input (B, H, W, 3) with H, W multiples of 16 (ImageNet-normalized, as the
    pretrain step passes its clip); output (B, H, W) fp32 depth. Parameters
    fp32, products in ``dtype``."""

    def __init__(self, vit_dim: int = 1024, vit_depth: int = 24, vit_heads: int = 16,
                 hooks: Sequence[int] = (5, 11, 17, 23),
                 reassemble_features: Sequence[int] = (256, 512, 1024, 1024),
                 features: int = 256, train_grid: int = 24, non_negative: bool = True,
                 dtype=torch.float32):
        super().__init__()
        d, rf = vit_dim, reassemble_features
        self.hooks, self.train_grid, self.non_negative = tuple(hooks), train_grid, non_negative
        vit = nn.Module()
        vit.patch_embed = nn.Module()
        vit.patch_embed.proj = Conv2d(3, d, 16, 16, compute_dtype=dtype)
        vit.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        vit.pos_embed = nn.Parameter(torch.zeros(1, 1 + train_grid ** 2, d))
        vit.blocks = nn.ModuleList(ViTBlock(d, vit_heads, dtype=dtype) for _ in range(vit_depth))
        self.pretrained = nn.Module()
        self.pretrained.model = vit
        # act_postprocess{n}: MiDaS's Sequential (readout, Transpose, Unflatten,
        # 1x1 conv, resample); the two reshapes hold no parameters
        resample = (UpConv(rf[0], 4, dtype), UpConv(rf[1], 2, dtype), None,
                    Conv2d(rf[3], rf[3], 3, 2, 1, compute_dtype=dtype))
        for n in range(4):
            layers = [ProjectReadout(d, dtype), nn.Identity(), nn.Identity(),
                      Conv2d(d, rf[n], 1, compute_dtype=dtype)]
            self.pretrained.add_module(f"act_postprocess{n + 1}", nn.Sequential(
                *layers, *(() if resample[n] is None else (resample[n],))))
        self.scratch = nn.Module()
        for n in range(4):
            self.scratch.add_module(f"layer{n + 1}_rn", Conv2d(
                rf[n], features, 3, padding=1, bias=False, compute_dtype=dtype))
            self.scratch.add_module(f"refinenet{n + 1}",
                                    FeatureFusionBlock(features, n != 3, dtype))
        # MiDaS's head: conv, Interpolate, conv, ReLU, conv (fp32), ReLU
        self.scratch.output_conv = nn.Sequential(
            Conv2d(features, features // 2, 3, padding=1, compute_dtype=dtype), nn.Identity(),
            Conv2d(features // 2, 32, 3, padding=1, compute_dtype=dtype), nn.Identity(),
            Conv2d(32, 1, 1))

    def forward(self, x):
        b, hh, ww, _ = x.shape
        gh, gw = hh // 16, ww // 16
        vit = self.pretrained.model
        d = vit.cls_token.shape[-1]
        tokens = vit.patch_embed.proj(x).reshape(b, gh * gw, d)
        pos = resize_pos_embed(vit.pos_embed, self.train_grid, gh, gw)
        tokens = torch.cat([vit.cls_token.to(tokens.dtype).expand(b, 1, d), tokens],
                           dim=1) + pos.to(tokens.dtype)
        captured = {}
        for i, block in enumerate(vit.blocks):
            tokens = block(tokens)
            if i in self.hooks:
                captured[self.hooks.index(i)] = tokens
        layers = []
        for n in range(4):
            ap = getattr(self.pretrained, f"act_postprocess{n + 1}")
            feat = ap[3](ap[0](captured[n]).reshape(b, gh, gw, d))
            if len(ap) > 4:
                feat = ap[4](feat)
            layers.append(getattr(self.scratch, f"layer{n + 1}_rn")(feat))
        sc = self.scratch
        path = sc.refinenet4(layers[3])
        for n in (2, 1, 0):
            path = getattr(sc, f"refinenet{n + 1}")(path, layers[n])
        head = sc.output_conv
        out = head[2](interp2x(head[0](path)))
        out = head[4](torch.relu(out))
        if self.non_negative:
            out = torch.relu(out)
        return out[..., 0]
