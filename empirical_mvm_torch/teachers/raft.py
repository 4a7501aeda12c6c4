"""Frozen RAFT optical-flow teacher, the teacher of the ``optical_flow`` MVM
target (counterpart of ``empirical_mvm_tpu/teachers/raft.py``; torchvision's
``raft_large``; ref: visbackbone/optical_flow/raft.py:29-508, 593,
_utils.py:35-77; main_pretrain.py:386-419).

Two 8x-downsampling encoders (features with instance norm on both frames,
context with frozen batch norm on the first), the all-pairs correlation of
the two feature maps and its 4-level average-pool pyramid, then 12 updates:
each looks up the (2r+1)^2 neighbourhood of every level around the current
correspondence, encodes it with the flow, steps the separable ConvGRU and
adds the flow head's delta; the final flow is upsampled 8x by the convex
combination of the mask predictor. Channel-last, as in the JAX package: the
convolutions in the model dtype through :class:`Conv2d`, the correlation in
fp32 and cast to the model dtype for the motion encoder, the flow state in
fp32, the flow head's and mask predictor's last convs in fp32; each update
starts from a detached ``coords1`` and only the final flow is upsampled.

The parameters carry torchvision's names (``feature_encoder.layer2.0.
downsample.0.weight``, ``update_block.recurrent_block.convgru1.convz.bias``,
``mask_predictor.conv.weight``); the context encoder's batch-norm
statistics are the buffers ``running_mean`` and ``running_var``, so the JAX
``raft_params_from_torch`` reads the port's state_dict.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from empirical_mvm_torch.models.common import Conv2d


class FrozenBatchNorm(nn.Module):
    """BatchNorm2d in eval mode on channel-last input, in fp32: ``weight``
    and ``bias`` with the running statistics as buffers (the JAX
    ``FrozenBatchNorm``, whose statistics are parameters there)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x.float() - self.running_mean) * inv + self.bias


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) on (B, H, W, C), in fp32: per sample and
    channel over H and W, biased variance."""
    x = x.float()
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


class ConvNormAct(nn.Sequential):
    """torchvision ``Conv2dNormActivation`` (``0`` the conv, ``1`` a frozen
    batch norm where ``norm`` is "bn"): conv with bias and torch's symmetric
    padding (k - 1) // 2, the norm ("in": :func:`instance_norm`), ReLU where
    ``act``, the result in ``dtype``."""

    def __init__(self, n_in: int, n_out: int, kernel: int = 3, stride: int = 1,
                 norm: str | None = None, act: bool = True, dtype=torch.float32):
        layers = [Conv2d(n_in, n_out, kernel, stride, (kernel - 1) // 2, compute_dtype=dtype)]
        if norm == "bn":
            layers.append(FrozenBatchNorm(n_out))
        super().__init__(*layers)
        self.norm, self.act, self.dtype = norm, act, dtype

    def forward(self, x):
        x = self[0](x)
        if self.norm == "in":
            x = instance_norm(x)
        elif self.norm == "bn":
            x = self[1](x)
        if self.act:
            x = torch.relu(x)
        return x.to(self.dtype)


class ResidualBlock(nn.Module):
    """(ref: raft.py:29-70): relu(x + two ConvNormAct), x through a 1x1
    ``downsample`` where the stride is not 1."""

    def __init__(self, n_in: int, n_out: int, norm: str | None, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.convnormrelu1 = ConvNormAct(n_in, n_out, 3, stride, norm, dtype=dtype)
        self.convnormrelu2 = ConvNormAct(n_out, n_out, 3, 1, norm, dtype=dtype)
        if stride != 1:
            self.downsample = ConvNormAct(n_in, n_out, 1, stride, norm, act=False, dtype=dtype)

    def forward(self, x):
        y = self.convnormrelu2(self.convnormrelu1(x))
        if hasattr(self, "downsample"):
            x = self.downsample(x)
        return torch.relu(x + y)


class FeatureEncoder(nn.Module):
    """8x downsampling encoder (ref: raft.py:115-158), layers (64, 64, 96,
    128, 256): a 7x7 stride-2 ConvNormAct, three stages of two residual
    blocks (strides 1, 2, 2), a 1x1 conv."""

    def __init__(self, layers: Sequence[int] = (64, 64, 96, 128, 256),
                 norm: str | None = "in", dtype=torch.float32):
        super().__init__()
        self.convnormrelu = ConvNormAct(3, layers[0], 7, 2, norm, dtype=dtype)
        n_in = layers[0]
        for i, stride in enumerate((1, 2, 2), start=1):
            n_out = layers[i]
            self.add_module(f"layer{i}", nn.Sequential(
                ResidualBlock(n_in, n_out, norm, stride, dtype),
                ResidualBlock(n_out, n_out, norm, 1, dtype)))
            n_in = n_out
        self.conv = Conv2d(n_in, layers[4], 1, compute_dtype=dtype)

    def forward(self, x):
        x = self.convnormrelu(x)
        return self.conv(self.layer3(self.layer2(self.layer1(x))))


class MotionEncoder(nn.Module):
    """(ref: raft.py:165-202): the correlation features through 1x1 and 3x3
    convs, the flow through 7x7 and 3x3, both through a 3x3 to 126
    channels, and the flow appended."""

    def __init__(self, in_channels_corr: int, dtype=torch.float32):
        super().__init__()
        self.convcorr1 = ConvNormAct(in_channels_corr, 256, 1, dtype=dtype)
        self.convcorr2 = ConvNormAct(256, 192, 3, dtype=dtype)
        self.convflow1 = ConvNormAct(2, 128, 7, dtype=dtype)
        self.convflow2 = ConvNormAct(128, 64, 3, dtype=dtype)
        self.conv = ConvNormAct(192 + 64, 128 - 2, 3, dtype=dtype)

    def forward(self, flow, corr_features):
        corr = self.convcorr2(self.convcorr1(corr_features))
        f = self.convflow2(self.convflow1(flow.to(corr.dtype)))
        x = self.conv(torch.cat([corr, f], dim=-1))
        return torch.cat([x, flow.to(x.dtype)], dim=-1)


class ConvGRU(nn.Module):
    """(ref: raft.py:205-221) with a (kh, kw) kernel and torch's padding."""

    def __init__(self, input_size: int, hidden_size: int, kernel, dtype=torch.float32):
        super().__init__()
        pad = ((kernel[0] - 1) // 2, (kernel[1] - 1) // 2)
        for name in ("convz", "convr", "convq"):
            self.add_module(name, Conv2d(hidden_size + input_size, hidden_size, kernel,
                                         padding=pad, compute_dtype=dtype))

    def forward(self, h, x):
        hx = torch.cat([h, x], dim=-1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=-1)))
        return (1 - z) * h + z * q


class RecurrentBlock(nn.Module):
    """The separable 1x5 + 5x1 GRU pair (ref: raft.py:228-256)."""

    def __init__(self, input_size: int, hidden_size: int = 128, dtype=torch.float32):
        super().__init__()
        self.convgru1 = ConvGRU(input_size, hidden_size, (1, 5), dtype)
        self.convgru2 = ConvGRU(input_size, hidden_size, (5, 1), dtype)

    def forward(self, h, x):
        return self.convgru2(self.convgru1(h, x), x)


class FlowHead(nn.Module):
    """(ref: raft.py:259-273): 3x3 conv, ReLU, 3x3 conv to the fp32 delta."""

    def __init__(self, in_channels: int = 128, hidden_size: int = 256, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_channels, hidden_size, 3, padding=1, compute_dtype=dtype)
        self.conv2 = Conv2d(hidden_size, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(torch.relu(self.conv1(x)))


class MaskPredictor(nn.Module):
    """(ref: raft.py:298-322): 3x3 ConvNormAct, a 1x1 conv to the fp32 8 x 8
    x 9 upsampling logits, times 0.25."""

    def __init__(self, in_channels: int = 128, hidden_size: int = 256,
                 multiplier: float = 0.25, dtype=torch.float32):
        super().__init__()
        self.convrelu = ConvNormAct(in_channels, hidden_size, 3, dtype=dtype)
        self.conv = Conv2d(hidden_size, 8 * 8 * 9, 1)
        self.multiplier = multiplier

    def forward(self, x):
        return self.multiplier * self.conv(self.convrelu(x))


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling at absolute pixel coordinates with zero padding,
    ``grid_sample(align_corners=True)`` on absolute coordinates (the JAX
    ``bilinear_sample``; ref: _utils.py:35-47): integer coordinates are the
    pixel centres, and a corner outside the image contributes 0.

    img (N, H, W, C); coords (N, P, 2) as (x, y) -> (N, P, C) fp32."""
    n, h, w, c = img.shape
    x, y = coords[..., 0].float(), coords[..., 1].float()
    x0, y0 = x.floor(), y.floor()
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    flat = img.float().reshape(n, h * w, c)

    def gather(xi, yi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        vals = flat.gather(1, idx[..., None].expand(-1, -1, c))
        return torch.where(inside[..., None], vals, 0.0)

    top = gather(x0, y0) * (1 - wx) + gather(x0 + 1, y0) * wx
    bot = gather(x0, y0 + 1) * (1 - wx) + gather(x0 + 1, y0 + 1) * wx
    return top * (1 - wy) + bot * wy


def build_corr_pyramid(f1: torch.Tensor, f2: torch.Tensor,
                       num_levels: int = 4) -> list[torch.Tensor]:
    """All-pairs correlation and its 2x2 average-pool pyramid (ref:
    raft.py:351-366, 395-405): f (B, h, w, C) fp32 -> levels of
    (B*h*w, h_l, w_l, 1), the correlation divided by sqrt(C)."""
    b, h, w, c = f1.shape
    corr = torch.bmm(f1.reshape(b, h * w, c), f2.reshape(b, h * w, c).transpose(1, 2))
    vol = (corr / math.sqrt(c)).reshape(b * h * w, 1, h, w)
    pyramid = [vol]
    for _ in range(num_levels - 1):
        vol = F.avg_pool2d(vol, 2)
        pyramid.append(vol)
    return [v.permute(0, 2, 3, 1) for v in pyramid]


def index_corr_pyramid(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                       radius: int = 4) -> torch.Tensor:
    """The (2r+1)^2 neighbourhood of every level around coords (B, h, w, 2)
    as (x, y) -> (B, h, w, L*(2r+1)^2) fp32 (ref: raft.py:368-393; the JAX
    ``index_corr_pyramid``). Channel di * (2r+1) + dj samples the point
    (x + di - r, y + dj - r) / 2^level: the first offset axis adds to x.

    Sampling an axis-aligned grid of points bilinearly with zero padding is
    separable: the weight of point (px, py) on cell (x, y) is tent(px - x)
    tent(py - y), and a corner outside the level drops out on its own axis.
    So each level is two batched products with per-point tent-weight
    matrices, (R, h_l, w_l) x (R, w_l, S) and (R, S, h_l) x (R, h_l, S),
    whose intermediates are (R, h_l, S): 47 MB at level 0 of 60 pairs at
    224^2, where JAX's broadcast sum holds (R, h_l, S, w_l). A 1 x 1 level
    needs no normalisation (``grid_sample``'s divides by w_l - 1 = 0)."""
    b, h, w, _ = coords.shape
    side = 2 * radius + 1
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=coords.device)
    cen = coords.reshape(b * h * w, 2).float()
    feats = []
    for vol in pyramid:
        r, hl, wl, _ = vol.shape
        px = cen[:, :1] + offs                                             # (R, S)
        py = cen[:, 1:] + offs
        xs = torch.arange(wl, dtype=torch.float32, device=coords.device)
        ys = torch.arange(hl, dtype=torch.float32, device=coords.device)
        ax = (1.0 - (px[:, :, None] - xs).abs()).clamp(min=0.0)           # (R, S, wl)
        ay = (1.0 - (py[:, :, None] - ys).abs()).clamp(min=0.0)           # (R, S, hl)
        t = torch.bmm(vol[..., 0], ax.transpose(1, 2))                     # (R, hl, S_x)
        o = torch.bmm(t.transpose(1, 2), ay.transpose(1, 2))               # (R, S_x, S_y)
        feats.append(o.reshape(r, side * side))
        cen = cen / 2
    return torch.cat(feats, dim=-1).reshape(b, h, w, -1)


def convex_upsample(flow: torch.Tensor, up_mask: torch.Tensor) -> torch.Tensor:
    """Convex-combination 8x upsampling (ref: _utils.py:57-77): flow (B, h,
    w, 2), up_mask (B, h, w, 9*8*8) -> (B, 8h, 8w, 2); each fine pixel a
    softmax-weighted mix of 8 x flow over its coarse cell's 3 x 3
    neighbourhood (zero padded), neighbour k = 3 (dy + 1) + (dx + 1)."""
    b, h, w, _ = flow.shape
    mask = torch.softmax(up_mask.reshape(b, h, w, 9, 8, 8), dim=3)
    pad = F.pad(8.0 * flow, (0, 0, 1, 1, 1, 1))
    neigh = torch.stack([pad[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)], dim=3)  # (B, h, w, 9, 2)
    up = torch.einsum("bhwkij,bhwkc->bhwijc", mask, neigh)                 # (B, h, w, 8, 8, 2)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(b, 8 * h, 8 * w, 2)


class RAFT(nn.Module):
    """raft_large (ref: raft.py:407-508, 593-640). Inputs (B, H, W, 3) with H,
    W multiples of 8 (ImageNet-normalized, as the pretrain step passes its
    frames); returns the final flow (B, H, W, 2) fp32. Parameters fp32,
    products in ``dtype``."""

    def __init__(self, num_levels: int = 4, radius: int = 4, hidden_size: int = 128,
                 num_updates: int = 12, dtype=torch.float32):
        super().__init__()
        self.num_levels, self.radius, self.hidden_size = num_levels, radius, hidden_size
        self.num_updates, self.dtype = num_updates, dtype
        self.feature_encoder = FeatureEncoder(norm="in", dtype=dtype)
        self.context_encoder = FeatureEncoder(norm="bn", dtype=dtype)
        corr_ch = num_levels * (2 * radius + 1) ** 2
        ctx_ch = 256 - hidden_size
        self.update_block = nn.Module()
        self.update_block.motion_encoder = MotionEncoder(corr_ch, dtype)
        self.update_block.recurrent_block = RecurrentBlock(ctx_ch + 128, hidden_size, dtype)
        self.update_block.flow_head = FlowHead(hidden_size, dtype=dtype)
        self.mask_predictor = MaskPredictor(hidden_size, dtype=dtype)

    def forward(self, image1, image2, num_updates: int | None = None):
        b, h, w, _ = image1.shape
        if h % 8 or w % 8:
            raise ValueError(f"RAFT needs sides that are multiples of 8, got {h} x {w}")
        fmaps = self.feature_encoder(torch.cat([image1, image2]))
        pyramid = build_corr_pyramid(fmaps[:b].float(), fmaps[b:].float(), self.num_levels)
        ctx = self.context_encoder(image1)
        hidden = torch.tanh(ctx[..., :self.hidden_size])
        context = torch.relu(ctx[..., self.hidden_size:])
        h8, w8 = h // 8, w // 8
        ys, xs = torch.meshgrid(torch.arange(h8, dtype=torch.float32, device=image1.device),
                                torch.arange(w8, dtype=torch.float32, device=image1.device),
                                indexing="ij")
        coords0 = torch.stack([xs, ys], dim=-1).expand(b, h8, w8, 2)
        ub = self.update_block
        coords1 = coords0
        for _ in range(num_updates or self.num_updates):
            coords1 = coords1.detach()
            corr = index_corr_pyramid(pyramid, coords1, self.radius)
            mf = ub.motion_encoder(coords1 - coords0, corr.to(self.dtype))
            hidden = ub.recurrent_block(hidden, torch.cat([context, mf], dim=-1))
            coords1 = coords1 + ub.flow_head(hidden)
        return convex_upsample(coords1 - coords0, self.mask_predictor(hidden))
