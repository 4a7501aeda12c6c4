"""Video Swin Transformer 3D (counterpart of
``empirical_mvm_tpu/models/video_swin.py``).

Channel-last ``(B, T, H, W, C)`` end to end, as in the JAX package, with the
reference's quirks: patch-embed stride (1, 4, 4) with a +1 temporal pad, the
window clamped per stage to the input extent with zero shift on clamped
dims, and the relative-position index built for the full window and sliced
``[:N, :N]`` (ref: visbackbone/video_swin.py:95-108,155,384-398).

Window attention picks its kernel as the JAX ``WindowAttention3D`` does
(``WindowAttention3D.forward``). Where the width C is a multiple of 128 (the
Swin-base stages): with one temporal window (D == wd, every Video Swin
stage: the temporal window clamps to T) :func:`direct_window_attention` on
the padded, rolled 5D map; otherwise (the per-frame 2D Swin, wd == 1 < D:
the frozen teacher or the trained ``swin2d`` backbone) the windows are
partitioned and :func:`lane_window_attention` runs them, forward and
backward. The JAX package folds 4 or 2 frames into one window there for the
TPU's block shapes and runs the t-sliced lane kernel; the CUDA kernel does
the same work on the frames' own windows. Where C is not a multiple of 128
(stages 0 and 1 of the C = 96 swins: tiny, small, violet) the qkv map is
copied once into (B_, 3nH, N, hd) windows and
:func:`packed_window_attention` runs them; on the 2D geometry the JAX
package runs that kernel on a 4-frame block-diagonal superwindow whose
off-diagonal bias is -1e9, which is the same function as the frames' own
windows that the port attends. The CUDA kernels run on the card, their
plain versions on the CPU.
LayerNorms are the plain :class:`LayerNorm`, as the JAX package keeps flax
``nn.LayerNorm`` in trained swins; a frozen teacher passes
``fused_norms=True`` and runs them through :class:`FusedLayerNorm` (the JAX
``use_pallas_layernorm=True``). Parameter names are the reference checkpoint's
(``layers.0.blocks.0.attn.qkv.weight``, ``patch_embed.proj.weight``, ...).
Training: stochastic depth at the reference's rates
(``np.linspace(0, drop_path_rate, sum(depths))``) and dropout at the JAX
package's sites (``drop_rate`` after the patch embedding, after each
attention's ``proj`` and twice in each MLP; ``attn_drop_rate`` on the
attention probabilities), all drawn from the generator passed to
``forward`` (none: the deterministic pass). A nonzero ``attn_drop_rate``
sends every window attention to :func:`window_attention_xla`, as it sends
the JAX package's to its XLA branch: no kernel drops probabilities there.
The relative-position bias table gets its gradient through autograd of
the index gather (the JAX package's ``rel_pos_bias`` custom VJP is an XLA
op). ``remat`` recomputes each block in the backward
(``models/common.remat``); scan is not ported.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from empirical_mvm_torch.core.config import SwinConfig
from empirical_mvm_torch.models.common import Linear, dropout, remat
from empirical_mvm_torch.ops.layernorm import FusedLayerNorm, LayerNorm
from empirical_mvm_torch.ops.patch_embed import patch_embed_3d
from empirical_mvm_torch.ops.window_attention import (direct_window_attention,
                                                      lane_window_attention,
                                                      packed_window_attention,
                                                      window_partition, window_reverse)


def get_window_size(x_size: Sequence[int], window_size: Sequence[int],
                    shift_size: Sequence[int]):
    """Clamp window and shift to the input extent: a dim no larger than its
    window takes the whole extent and no shift (ref: visbackbone/video_swin.py:95-108)."""
    use_window, use_shift = list(window_size), list(shift_size)
    for i, xs in enumerate(x_size):
        if xs <= window_size[i]:
            use_window[i] = xs
            use_shift[i] = 0
    return tuple(use_window), tuple(use_shift)


@functools.lru_cache(maxsize=None)
def _relative_position_index(window_size: tuple[int, int, int]) -> np.ndarray:
    """(N, N) index into the rel-pos-bias table for the FULL window
    (ref: visbackbone/video_swin.py:123-137)."""
    wd, wh, ww = window_size
    coords = np.stack(np.meshgrid(np.arange(wd), np.arange(wh), np.arange(ww),
                                  indexing="ij")).reshape(3, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wd - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= 2 * ww - 1
    return rel.sum(-1).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _shift_attn_mask(dims: tuple[int, int, int],
                     window_size: tuple[int, int, int],
                     shift_size: tuple[int, int, int]) -> np.ndarray:
    """(nW, N, N) fp32 additive mask for shifted windows, windows row-major
    as (d, h-strip, w), tokens as (t, i, j) (ref: visbackbone/video_swin.py:292-307)."""
    dp, hp, wp = dims
    img_mask = np.zeros((1, dp, hp, wp, 1), dtype=np.float32)
    cnt = 0
    for d in (slice(-window_size[0]), slice(-window_size[0], -shift_size[0]),
              slice(-shift_size[0], None)):
        for h in (slice(-window_size[1]), slice(-window_size[1], -shift_size[1]),
                  slice(-shift_size[1], None)):
            for w in (slice(-window_size[2]), slice(-window_size[2], -shift_size[2]),
                      slice(-shift_size[2], None)):
                img_mask[:, d, h, w, :] = cnt
                cnt += 1
    wd, wh, ww = window_size
    n = wd * wh * ww
    m = img_mask.reshape(1, dp // wd, wd, hp // wh, wh, wp // ww, ww, 1)
    m = m.transpose(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, n)
    attn_mask = m[:, None, :] - m[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


def drop_path(x: torch.Tensor, rate: float,
              generator: torch.Generator | None) -> torch.Tensor:
    """Stochastic depth (JAX ``drop_path``, ref: visbackbone/video_swin.py:46-63):
    each sample's residual branch is kept with probability 1 - rate and then
    divided by it."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, x.new_zeros(()))


class Mlp(nn.Module):
    """fc1 -> exact GELU -> dropout -> fc2 -> dropout (ref:
    visbackbone/video_swin.py:65-81); the dropout at ``drop`` draws from the
    generator."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype, drop: float = 0.0):
        super().__init__()
        self.drop = drop
        self.fc1 = Linear(dim, hidden, compute_dtype=dtype)
        self.fc2 = Linear(hidden, dim, compute_dtype=dtype)

    def forward(self, x, generator=None):
        x = dropout(F.gelu(self.fc1(x)), self.drop, generator)
        return dropout(self.fc2(x), self.drop, generator)


def window_attention_xla(qkv: torch.Tensor, bias: torch.Tensor, mask: torch.Tensor | None,
                         n_heads: int, scale: float, p_drop: float = 0.0,
                         generator: torch.Generator | None = None) -> torch.Tensor:
    """The JAX package's XLA window attention (``WindowAttention3D``'s einsum
    branch, video_swin.py:453-470), which it runs wherever ``attn_drop_rate``
    is not 0: qkv (B_, N, 3C) of the partitioned windows, bias (nH, N, N),
    mask (nW, N, N) with the windows innermost in B_ or None. fp32 scores of
    q * scale (rounded to qkv's dtype) and k, the bias and the mask added,
    an fp32 softmax; the probabilities cast to qkv's dtype and dropped at
    ``p_drop`` (drawn from ``generator``) weight v. Returns (B_, N, C)."""
    b_, n, c3 = qkv.shape
    c = c3 // 3
    q, k, v = qkv.reshape(b_, n, 3, n_heads, c // n_heads).permute(2, 0, 3, 1, 4)
    s = torch.matmul((q * scale).float(), k.float().transpose(-1, -2)) + bias[None]
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(b_ // nw, nw, n_heads, n, n) + mask[None, :, None]).reshape(s.shape)
    p = dropout(torch.softmax(s, dim=-1).to(qkv.dtype), p_drop, generator)
    out = torch.matmul(p.float(), v.float()).to(qkv.dtype)
    return out.transpose(1, 2).reshape(b_, n, c)


def _to_packed(qkv: torch.Tensor, window: Sequence[int], n_heads: int) -> torch.Tensor:
    """(B, D, H, W, 3C) qkv map, last axis (3, nH, hd) -> (B_, 3nH, N, hd):
    the window partition and the head transpose in one copy."""
    b, d, h, w, c3 = qkv.shape
    wd, wh, ww = window
    x = qkv.reshape(b, d // wd, wd, h // wh, wh, w // ww, ww, 3 * n_heads, -1)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6, 8)
    return x.reshape(-1, 3 * n_heads, wd * wh * ww, c3 // (3 * n_heads)).contiguous()


def _from_packed(out: torch.Tensor, window: Sequence[int], b: int, d: int, h: int,
                 w: int) -> torch.Tensor:
    """(B_, nH, N, hd) window outputs -> (B, D, H, W, C), heads innermost:
    the inverse of :func:`_to_packed` for one segment, in one copy."""
    wd, wh, ww = window
    _, nh, _, hd = out.shape
    x = out.reshape(b, d // wd, h // wh, w // ww, nh, wd, wh, ww, hd)
    return x.permute(0, 1, 5, 2, 6, 3, 7, 4, 8).reshape(b, d, h, w, nh * hd)


class WindowAttention3D(nn.Module):
    """3D window attention with relative position bias on the padded, rolled
    5D feature map (ref: visbackbone/video_swin.py:111-172)."""

    def __init__(self, dim: int, window_size: tuple[int, int, int],
                 num_heads: int, qkv_bias: bool = True,
                 qk_scale: float | None = None, dtype=torch.float32,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.dim = dim
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.window_size = tuple(window_size)
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        wd, wh, ww = self.window_size
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1), num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.tensor(_relative_position_index(self.window_size)),
            persistent=False)      # torch.tensor honours a default device
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, compute_dtype=dtype)
        self.proj = Linear(dim, dim, compute_dtype=dtype)

    def rel_pos_bias(self, n: int) -> torch.Tensor:
        """(nH, N, N) fp32 bias of the effective window: the full window's
        index sliced [:N, :N] (ref: visbackbone/video_swin.py:155)."""
        idx = self.relative_position_index[:n, :n].reshape(-1)
        bias = self.relative_position_bias_table[idx].reshape(n, n, -1)
        return bias.permute(2, 0, 1).float().contiguous()

    def route(self, dp: int, wd: int) -> str:
        """The attention of a map of Dp frames under a temporal window wd:
        ``"xla"`` (:func:`window_attention_xla`) where ``attn_drop`` is not
        0, as the JAX package routes it; else ``"direct"`` (C % 128 == 0 and
        one temporal window, D == wd), ``"lane_window"`` (C % 128 == 0) or
        ``"packed"`` (any other C)."""
        if self.attn_drop > 0.0:
            return "xla"
        if self.dim % 128:
            return "packed"
        return "direct" if dp == wd else "lane_window"

    def forward(self, x, mask, window_eff, generator=None):
        """x (B, Dp, Hp, Wp, C) padded and rolled; mask (nW, N, N) fp32 over
        all (Dp/wd) * nW_hw windows, or None; ``generator`` draws the
        dropouts (none: the deterministic pass).

        The kernel (:meth:`route`): for C % 128 == 0, the direct kernel with
        one temporal window (D == wd), else the lane window kernel on the
        partitioned windows; for any other C the packed kernel, its (B_,
        3nH, N, hd) input one copy of the qkv map (:func:`_to_packed`; the
        JAX package partitions before the qkv GEMM and transposes after it,
        two copies) and its output one copy back to the map. The C % 128
        rule is the JAX package's (its ``direct_attention_fits`` and
        ``lane_attention_fits`` refuse such C: the TPU's 128-lane blocks),
        kept so that both packages run the same kernel in each stage; the
        CUDA kernels take any C. The JAX checks' VMEM budgets have no
        counterpart. With ``attn_drop`` the partitioned windows take
        :func:`window_attention_xla`, the probabilities dropped there."""
        b, dp, hp, wp, c = x.shape
        wd, wh, ww = window_eff
        n = wd * wh * ww
        nh, nw = self.num_heads, 1 if mask is None else mask.shape[0]
        bias, scale = self.rel_pos_bias(n), float(self.scale)
        route = self.route(dp, wd)

        def proj(t):
            return dropout(self.proj(t), self.proj_drop, generator)

        if route == "direct":
            return proj(direct_window_attention(self.qkv(x), bias, mask, window_eff, nh, scale))
        if route == "packed":
            out = packed_window_attention(_to_packed(self.qkv(x), window_eff, nh), bias, mask,
                                          nw, nh, scale)
            return proj(_from_packed(out, window_eff, b, dp, hp, wp))
        xw = self.qkv(window_partition(x, window_eff))              # (B_, N, 3C)
        if route == "xla":
            out = window_attention_xla(xw, bias, mask, nh, scale,
                                       self.attn_drop if generator is not None else 0.0,
                                       generator)
        else:
            out = lane_window_attention(xw, bias, mask, nw, nh, scale)
        return window_reverse(proj(out), window_eff, b, dp, hp, wp)


class SwinTransformerBlock3D(nn.Module):
    """Windowed MSA + MLP with cyclic shift (ref: visbackbone/video_swin.py:175-263)."""

    def __init__(self, dim, num_heads, window_size, shift_size, mlp_ratio=4.0,
                 qkv_bias=True, qk_scale=None, dtype=torch.float32,
                 drop_path_rate: float = 0.0, norm=LayerNorm, drop: float = 0.0,
                 attn_drop: float = 0.0):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.window_size = tuple(window_size)
        self.shift_size = tuple(shift_size)
        self.norm1 = norm(dim)
        self.attn = WindowAttention3D(dim, self.window_size, num_heads,
                                      qkv_bias, qk_scale, dtype, attn_drop, drop)
        self.norm2 = norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, drop)

    def forward(self, x, attn_mask, generator=None):
        b, d, h, w, c = x.shape
        window, shift = get_window_size((d, h, w), self.window_size,
                                        self.shift_size)
        shortcut = x
        x = self.norm1(x)
        pad_d = (-d) % window[0]
        pad_b = (-h) % window[1]
        pad_r = (-w) % window[2]
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b, 0, pad_d))
        shifted = any(s > 0 for s in shift)
        if shifted:
            x = torch.roll(x, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
        x = self.attn(x, attn_mask if shifted else None, window, generator)
        if shifted:
            x = torch.roll(x, shifts=shift, dims=(1, 2, 3))
        rate = self.drop_path_rate
        x = shortcut + drop_path(x[:, :d, :h, :w, :], rate, generator)
        return x + drop_path(self.mlp(self.norm2(x), generator), rate, generator)


class PatchMerging(nn.Module):
    """2x2 spatial merge between stages (ref: visbackbone/video_swin.py:266-289)."""

    def __init__(self, dim: int, dtype=torch.float32, norm=LayerNorm):
        super().__init__()
        self.norm = norm(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, compute_dtype=dtype)

    def forward(self, x):
        h, w = x.shape[2], x.shape[3]
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                       x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    """One Swin stage (ref: visbackbone/video_swin.py:310-370): blocks
    alternate unshifted and half-window-shifted, then an optional merge."""

    def __init__(self, dim, depth, num_heads, window_size, mlp_ratio=4.0,
                 qkv_bias=True, qk_scale=None, downsample=False,
                 dtype=torch.float32, drop_path_rates: Sequence[float] = (),
                 norm=LayerNorm, remat: bool = False, drop: float = 0.0,
                 attn_drop: float = 0.0):
        super().__init__()
        self.remat = remat
        self.window_size = tuple(window_size)
        half = tuple(s // 2 for s in self.window_size)
        rates = list(drop_path_rates) or [0.0] * depth
        self.blocks = nn.ModuleList([
            SwinTransformerBlock3D(dim, num_heads, self.window_size,
                                   (0, 0, 0) if i % 2 == 0 else half,
                                   mlp_ratio, qkv_bias, qk_scale, dtype, rates[i], norm,
                                   drop, attn_drop)
            for i in range(depth)])
        self.downsample = PatchMerging(dim, dtype, norm) if downsample else None
        self._masks: dict = {}      # shift masks on the device, by shape

    def _shift_mask(self, dims, window, shift, device) -> torch.Tensor:
        key = (dims, window, shift, device)
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(
                _shift_attn_mask(dims, window, shift)).to(device)
        return self._masks[key]

    def forward(self, x, generator=None):
        b, d, h, w, c = x.shape
        window, shift = get_window_size(
            (d, h, w), self.window_size, tuple(s // 2 for s in self.window_size))
        dims = tuple(-(-s // ws) * ws for s, ws in zip((d, h, w), window))
        mask = self._shift_mask(dims, window, shift, x.device)
        for blk in self.blocks:
            x = remat(blk, generator, x, mask) if self.remat else blk(x, mask, generator)
        if self.downsample is not None:
            x = self.downsample(x)
        return x


class PatchEmbed3D(nn.Module):
    """Holds the reference's ``patch_embed.proj`` (Conv3d weight, OIDHW) and
    ``patch_embed.norm``; computes through :func:`patch_embed_3d`."""

    def __init__(self, patch_size, in_chans, embed_dim, patch_norm, dtype, norm=LayerNorm):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.dtype = dtype
        self.proj = nn.Conv3d(in_chans, embed_dim, kernel_size=self.patch_size,
                              stride=(1, *self.patch_size[1:]))
        self.norm = norm(embed_dim) if patch_norm else None

    def forward(self, x):
        x = patch_embed_3d(x, self.proj.weight, self.proj.bias,
                           self.patch_size, self.dtype)
        return x if self.norm is None else self.norm(x)


class SwinTransformer3D(nn.Module):
    """Full backbone (ref: visbackbone/video_swin.py:410-482).

    Input ``(B, T, H, W, 3)`` channel-last, normalized; output
    ``(B, T, H/32, W/32, num_features)``, after the final LayerNorm when the
    config has one. ``fused_norms=True`` runs every LayerNorm through the
    kernel (:class:`FusedLayerNorm`), as the JAX package does for frozen
    teachers.
    """

    def __init__(self, cfg: SwinConfig, dtype=torch.float32, fused_norms: bool = False):
        super().__init__()
        self.drop_rate = cfg.drop_rate
        norm = FusedLayerNorm if fused_norms else LayerNorm
        self.patch_embed = PatchEmbed3D(cfg.patch_size, 3, cfg.embed_dim,
                                        cfg.patch_norm, dtype, norm)
        n = len(cfg.depths)
        dpr = np.linspace(0, cfg.drop_path_rate, sum(cfg.depths)).tolist()
        starts = np.cumsum((0,) + tuple(cfg.depths)).tolist()
        self.layers = nn.ModuleList([
            BasicLayer(cfg.embed_dim * 2 ** i, depth, cfg.num_heads[i],
                       cfg.window_size, cfg.mlp_ratio, cfg.qkv_bias,
                       cfg.qk_scale, downsample=i < n - 1, dtype=dtype,
                       drop_path_rates=dpr[starts[i]:starts[i] + depth], norm=norm,
                       remat=cfg.remat, drop=cfg.drop_rate, attn_drop=cfg.attn_drop_rate)
            for i, depth in enumerate(cfg.depths)])
        self.norm = norm(cfg.num_features) if cfg.final_norm else None

    def forward(self, x, generator=None):
        """``generator`` drives stochastic depth and dropout; None is the
        deterministic pass."""
        x = dropout(self.patch_embed(x), self.drop_rate, generator)
        for layer in self.layers:
            x = layer(x, generator)
        return x if self.norm is None else self.norm(x)
