"""2D image encoders (counterpart of ``empirical_mvm_tpu/models/encoders2d.py``).

:func:`swin2d_config` builds the :class:`SwinConfig` under which the port's
3D ``SwinTransformer3D`` computes a per-frame 2D Swin (HF
``microsoft/swin-{size}-patch4-window7-224``): frozen, it is the feature
teacher of the ``2d_feature`` MVM target; trained, it is the backbone of
:class:`EncImgSwin` (``vis_backbone="swin"`` or ``"swin2d"``, mean or concat
temporal fusion; ref: visbackbone/swin.py:37-160). Its window attention runs
the lane window kernel, forward and backward, on each frame's 7 x 7 windows.

:class:`EncImgR50` (``vis_backbone="r50"``, mean or concat fusion; ref:
visbackbone/resnet50.py:6-120) runs the torchvision ResNet-50 trunk
(:class:`ResNet50`, torchvision's names: ``conv1``, ``bn1``,
``layer{1-4}.{i}.conv{1-3}``, ``bn{1-3}``, ``downsample.{0,1}``) frame by
frame, its 1 x 1 ``proj`` and a ReLU; :class:`EncImgMerlot`
(``vis_backbone="merlot"``; ref: visbackbone/merlot.py:7-95) adds a ViT-base
encoder per frame (``vit.{i}``, the timm block of ``teachers/dpt.py``),
trained. The convolutions run cuDNN on channel-last maps (:class:`Conv2d`),
as the JAX package runs them outside any Pallas kernel.

Their :class:`BatchNorm2d` (``models.common``) computes in fp32. Eval mode normalizes by the
running statistics, which are buffers (``running_mean``, ``running_var``),
not parameters: no gradient or weight decay reaches them. Train mode
(``r50_train_bn`` on a training pass) normalizes by the batch mean and
biased variance over (N, H, W), of the global batch under
``parallel.mesh.data_parallel``, and keeps the batch statistics until the
train step folds them into the running ones after its update
(:func:`fold_bn_stats`, torch's momentum rule). The JAX package keeps the
running statistics among its parameters, where AdamW's weight decay shrinks
them each step (ROADMAP Queue 3); the port does not copy that.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from empirical_mvm_torch.core.config import ModelConfig, SwinConfig
from empirical_mvm_torch.models.common import BatchNorm2d, Conv2d, Linear
from empirical_mvm_torch.models.video_swin import SwinTransformer3D
from empirical_mvm_torch.ops.layernorm import FusedLayerNorm, LayerNorm
from empirical_mvm_torch.teachers.dpt import ViTBlock

SWIN2D_SIZES = {
    # (embed_dim, depths, num_heads) for microsoft/swin-{size}-patch4-window7-224
    "tiny": (96, (2, 2, 6, 2), (3, 6, 12, 24)),
    "small": (96, (2, 2, 18, 2), (3, 6, 12, 24)),
    "base": (128, (2, 2, 18, 2), (4, 8, 16, 32)),
    "large": (192, (2, 2, 18, 2), (6, 12, 24, 48)),
}


def swin2d_config(size: str) -> SwinConfig:
    """Patch (1, 4, 4) and window (1, 7, 7): a 2D Swin run frame by frame.
    ``final_norm=False``: the reference consumes HF ``hidden_states[-1]``,
    the last stage's output before ``SwinModel``'s final LayerNorm
    (ref: visbackbone/swin.py:75-77, main_pretrain.py:537)."""
    dim, depths, heads = SWIN2D_SIZES[size]
    return SwinConfig(patch_size=(1, 4, 4), embed_dim=dim, depths=depths,
                      num_heads=heads, window_size=(1, 7, 7), final_norm=False)


def _check_fusion(fusion: str) -> None:
    if fusion not in ("mean", "concat"):
        raise ValueError(f"temporal fusion {fusion!r} is not mean or concat")


class _PosEmbeds(nn.Module):
    """The cls / pos / len (and odr) embeddings and the norm of the 2D
    encoders (JAX ``_PosEmbeds``, ref: visbackbone/swin.py:46-54). The norm
    runs through the kernel (:class:`FusedLayerNorm`), as the JAX
    ``layer_norm(..., use_pallas=None)`` gives. ``emb_odr`` (frame order) is
    created where JAX creates it (the swin's concat fusion, every R50 and
    MERLOT encoder) and not used by the forward, as in JAX."""

    def __init__(self, hidden: int, max_size_frame: int = 6, max_size_patch: int = 14,
                 with_odr: bool = True):
        super().__init__()
        self.emb_cls = nn.Parameter(torch.zeros(1, 1, 1, hidden))
        self.emb_pos = nn.Parameter(torch.zeros(1, 1, 1 + max_size_patch ** 2, hidden))
        self.emb_len = nn.Parameter(torch.zeros(1, max_size_frame, 1, hidden))
        self.emb_odr = nn.Parameter(torch.zeros(1, 1, 1, hidden)) if with_odr else None
        self.norm = FusedLayerNorm(hidden, 1e-5)

    def forward(self, f: torch.Tensor, add_len: bool = True) -> torch.Tensor:
        """f (B, T, hw, D) -> tokens (B, T, 1 + hw, D)."""
        b, t, hw, d = f.shape
        cls = self.emb_cls.to(f.dtype).expand(b, t, 1, d)
        f = torch.cat([cls, f], dim=2)
        f = f + self.emb_pos[:, :, :1 + hw].to(f.dtype)
        if add_len:
            f = f + self.emb_len[:, :t].to(f.dtype)
        return self.norm(f)


class EncImgSwin(nn.Module):
    """Trained 2D Swin encoder with mean or concat temporal fusion (JAX
    ``EncImgSwin``, ref: visbackbone/swin.py:37-160): the per-frame swin
    (``swin_custom``, else ``swin2d_config(vis_backbone_size)``; plain
    LayerNorms, stochastic depth drawn from the generator), ``swin2bert``
    to the hidden size, then the embeddings. Mean fusion averages the frames
    and continues with one.

    Input ``img (B, T, H, W, 3)`` normalized float (the train step normalizes
    uint8 clips first). Output ``feat (B, t * (1 + h * w), D)`` and ``mask``
    of ones, t = T for concat and 1 for mean. As in JAX, ``odr`` is not
    read and ``vt_mask`` ((B, T * (1 + h * w)) in any shape of that size)
    multiplies the mask under concat fusion only.
    """

    def __init__(self, cfg: ModelConfig, fusion: str = "concat", dtype=torch.float32):
        super().__init__()
        _check_fusion(fusion)
        swin = cfg.swin_custom if cfg.swin_custom is not None else swin2d_config(
            cfg.vis_backbone_size)
        self.fusion = fusion
        self.swin = SwinTransformer3D(swin, dtype)
        self.swin2bert = Linear(swin.num_features, cfg.hidden_size, compute_dtype=dtype)
        self.embeds = _PosEmbeds(cfg.hidden_size, cfg.max_size_frame, cfg.max_size_patch,
                                with_odr=fusion == "concat")

    def forward(self, img, generator=None, *, odr=None, vt_mask=None):
        b, t, hh, ww, _ = img.shape
        hw = (hh // 32) * (ww // 32)
        f = self.swin(img, generator)
        f = self.swin2bert(f.reshape(b, t, hw, f.shape[-1]))
        if self.fusion == "mean":
            f = f.mean(dim=1, keepdim=True)                # (ref: swin.py:79-80)
            t = 1
        f = self.embeds(f)
        m = torch.ones((b, t * (1 + hw)), dtype=torch.int32, device=f.device)
        if vt_mask is not None and self.fusion == "concat":
            m = m * vt_mask.reshape(b, -1).to(m.dtype)
        return f.reshape(b, t * (1 + hw), f.shape[-1]), m


class BottleneckBlock(nn.Module):
    """torchvision's ResNet bottleneck (1x1 -> 3x3 -> 1x1, expansion 4); the
    first block of a stage projects the shortcut (``downsample``)."""

    def __init__(self, in_ch: int, features: int, stride: int = 1, project: bool = False,
                 dtype=torch.float32):
        super().__init__()
        f = features
        self.conv1 = Conv2d(in_ch, f, 1, bias=False, compute_dtype=dtype)
        self.bn1 = BatchNorm2d(f)
        self.conv2 = Conv2d(f, f, 3, stride, 1, bias=False, compute_dtype=dtype)
        self.bn2 = BatchNorm2d(f)
        self.conv3 = Conv2d(f, 4 * f, 1, bias=False, compute_dtype=dtype)
        self.bn3 = BatchNorm2d(4 * f)
        self.downsample = nn.Sequential(
            Conv2d(in_ch, 4 * f, 1, stride, bias=False, compute_dtype=dtype),
            BatchNorm2d(4 * f)) if project else None

    def forward(self, x, use_batch_stats: bool = False):
        y = torch.relu(self.bn1(self.conv1(x), use_batch_stats))
        y = torch.relu(self.bn2(self.conv2(y), use_batch_stats))
        y = self.bn3(self.conv3(y), use_batch_stats)
        if self.downsample is not None:
            x = self.downsample[1](self.downsample[0](x), use_batch_stats)
        return torch.relu(x + y)


class ResNet50(nn.Module):
    """The torchvision resnet50 trunk without avgpool and fc (ref:
    visbackbone/resnet50.py:17-24 keeps ``children()[:-2]``): (N, H, W, 3)
    -> (N, H/32, W/32, 2048) fp32. The stem's max-pool pads with -inf, as
    JAX's pad-then-pool does."""

    STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False, compute_dtype=dtype)
        self.bn1 = BatchNorm2d(64)
        in_ch = 64
        for li, (f, n, s) in enumerate(self.STAGES, start=1):
            blocks = []
            for bi in range(n):
                blocks.append(BottleneckBlock(in_ch, f, s if bi == 0 else 1, bi == 0, dtype))
                in_ch = 4 * f
            setattr(self, f"layer{li}", nn.Sequential(*blocks))

    def forward(self, x, use_batch_stats: bool = False):
        x = torch.relu(self.bn1(self.conv1(x), use_batch_stats))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for li in range(1, len(self.STAGES) + 1):
            for block in getattr(self, f"layer{li}"):
                x = block(x, use_batch_stats)
        return x


class EncImgR50(nn.Module):
    """ResNet-50 encoder with mean or concat temporal fusion (JAX
    ``EncImgR50``, ref: visbackbone/resnet50.py:6-120): the trunk frame by
    frame, ``proj`` (the reference's 1x1 conv, a Linear on the channel-last
    map) and a ReLU, then the embeddings. ``train_bn`` (``r50_train_bn``)
    normalizes by batch statistics on a training pass (a generator given).

    Input ``img (B, T, H, W, 3)`` float; output ``feat (B, t * (1 + h * w),
    D)`` and a mask of ones, t = T for concat and 1 for mean. ``odr`` and
    ``vt_mask`` are taken and not read, as in JAX."""

    def __init__(self, cfg: ModelConfig, fusion: str = "concat", train_bn: bool = False,
                 dtype=torch.float32):
        super().__init__()
        _check_fusion(fusion)
        self.fusion, self.train_bn = fusion, train_bn
        self.res = ResNet50(dtype)
        self.proj = Linear(2048, cfg.hidden_size, compute_dtype=dtype)
        self.embeds = _PosEmbeds(cfg.hidden_size, cfg.max_size_frame, cfg.max_size_patch)

    def features(self, img, generator=None):
        """(B, T, h * w, D): the trunk, ``proj`` and the ReLU."""
        b, t, hh, ww, _ = img.shape
        f = self.res(img.reshape(b * t, hh, ww, 3), self.train_bn and generator is not None)
        return torch.relu(self.proj(f)).reshape(b, t, (hh // 32) * (ww // 32), -1)

    def forward(self, img, generator=None, *, odr=None, vt_mask=None):
        f = self.features(img, generator)
        b, t, hw = f.shape[:3]
        if self.fusion == "mean":
            f = f.mean(dim=1, keepdim=True)
            t = 1
        f = self.embeds(f)
        m = torch.ones((b, t * (1 + hw)), dtype=torch.int32, device=f.device)
        return f.reshape(b, t * (1 + hw), f.shape[-1]), m


class EncImgMerlot(EncImgR50):
    """The MERLOT-style encoder (JAX ``EncImgMerlot``, ref:
    visbackbone/merlot.py:7-95): the R50 features, ``proj`` and ReLU, the
    cls and pos embeddings and the norm, ``vit_depth`` ViT-base blocks per
    frame (width ``hidden_size``, the fusion's heads), a second ``emb_pos``
    add, ``emb_len``, then ``out_norm`` (a plain LayerNorm, as JAX's flax
    ``nn.LayerNorm``). Concat fusion only.

    The blocks are trained. Their LayerNorms run the kernel (rows 1-2), as
    JAX's ``layer_norm(..., None)`` does; their attention runs
    :func:`vit_self_attention` (p = 0, a zero mask: row 5 and its backward,
    row 6, where ``lane_sa_attention_fits``, else row 11), where the JAX
    package computes it in XLA (``ViTBlock(use_pallas=False)``): the
    kernels are the port's choice. ``odr`` and ``vt_mask`` are taken and
    not read, as in JAX."""

    def __init__(self, cfg: ModelConfig, train_bn: bool = False, vit_depth: int = 12,
                 dtype=torch.float32):
        super().__init__(cfg, "concat", train_bn, dtype)
        d = cfg.hidden_size
        self.vit = nn.ModuleList([ViTBlock(d, cfg.fusion.num_attention_heads, dtype=dtype)
                                  for _ in range(vit_depth)])
        self.out_norm = LayerNorm(d, 1e-5)

    def forward(self, img, generator=None, *, odr=None, vt_mask=None):
        f = self.embeds(self.features(img, generator), add_len=False)
        b, t, l, d = f.shape
        x = f.reshape(b * t, l, d)
        for blk in self.vit:
            x = blk(x)
        f = x.reshape(b, t, l, d) + self.embeds.emb_pos[:, :, :l].to(x.dtype)
        f = self.out_norm(f + self.embeds.emb_len[:, :t].to(f.dtype))
        m = torch.ones((b, t * l), dtype=torch.int32, device=f.device)
        return f.reshape(b, t * l, d), m
