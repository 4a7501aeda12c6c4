"""2D image encoders (counterpart of ``empirical_mvm_tpu/models/encoders2d.py``).

:func:`swin2d_config` builds the :class:`SwinConfig` under which the port's
3D ``SwinTransformer3D`` computes a per-frame 2D Swin (HF
``microsoft/swin-{size}-patch4-window7-224``): frozen, it is the feature
teacher of the ``2d_feature`` MVM target; trained, it is the backbone of
:class:`EncImgSwin` (``vis_backbone="swin"`` or ``"swin2d"``, mean or concat
temporal fusion; ref: visbackbone/swin.py:37-160). Its window attention runs
the lane window kernel, forward and backward, on each frame's 7 x 7 windows.
The ResNet-50 and MERLOT encoders are not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from empirical_mvm_torch.core.config import ModelConfig, SwinConfig
from empirical_mvm_torch.models.common import Linear
from empirical_mvm_torch.models.video_swin import SwinTransformer3D
from empirical_mvm_torch.ops.layernorm import FusedLayerNorm

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


class _PosEmbeds(nn.Module):
    """The cls / pos / len (and, for concat fusion, odr) embeddings and the
    norm of the 2D encoders (JAX ``_PosEmbeds``, ref: visbackbone/swin.py:46-54).
    The norm runs through the kernel (:class:`FusedLayerNorm`), as the JAX
    ``layer_norm(..., use_pallas=None)`` gives. ``emb_odr`` (frame order) is
    created for concat fusion and not used by the forward, as in JAX."""

    def __init__(self, hidden: int, max_size_frame: int = 6, max_size_patch: int = 14,
                 with_odr: bool = True):
        super().__init__()
        self.emb_cls = nn.Parameter(torch.zeros(1, 1, 1, hidden))
        self.emb_pos = nn.Parameter(torch.zeros(1, 1, 1 + max_size_patch ** 2, hidden))
        self.emb_len = nn.Parameter(torch.zeros(1, max_size_frame, 1, hidden))
        self.emb_odr = nn.Parameter(torch.zeros(1, 1, 1, hidden)) if with_odr else None
        self.norm = FusedLayerNorm(hidden, 1e-5)

    def forward(self, f: torch.Tensor) -> torch.Tensor:
        """f (B, T, hw, D) -> tokens (B, T, 1 + hw, D)."""
        b, t, hw, d = f.shape
        cls = self.emb_cls.to(f.dtype).expand(b, t, 1, d)
        f = torch.cat([cls, f], dim=2)
        f = f + self.emb_pos[:, :, :1 + hw].to(f.dtype)
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
    of ones, t = T for concat and 1 for mean.
    """

    def __init__(self, cfg: ModelConfig, fusion: str = "concat", dtype=torch.float32):
        super().__init__()
        if fusion not in ("mean", "concat"):
            raise ValueError(f"temporal fusion {fusion!r} is not mean or concat")
        swin = cfg.swin_custom if cfg.swin_custom is not None else swin2d_config(
            cfg.vis_backbone_size)
        self.fusion = fusion
        self.swin = SwinTransformer3D(swin, dtype)
        self.swin2bert = Linear(swin.num_features, cfg.hidden_size, compute_dtype=dtype)
        self.embeds = _PosEmbeds(cfg.hidden_size, cfg.max_size_frame, cfg.max_size_patch,
                                with_odr=fusion == "concat")

    def forward(self, img, generator=None):
        b, t, hh, ww, _ = img.shape
        hw = (hh // 32) * (ww // 32)
        f = self.swin(img, generator)
        f = self.swin2bert(f.reshape(b, t, hw, f.shape[-1]))
        if self.fusion == "mean":
            f = f.mean(dim=1, keepdim=True)                # (ref: swin.py:79-80)
            t = 1
        f = self.embeds(f)
        m = torch.ones((b, t * (1 + hw)), dtype=torch.int32, device=f.device)
        return f.reshape(b, t * (1 + hw), f.shape[-1]), m
