"""VIOLET trunk (counterpart of ``empirical_mvm_tpu/models/violet.py``):
video encoder, text embeddings, cross-modal fusion, and the score head.

Covers what the retrieval eval and the pretrain step run: the ``vidswin``
backbone, the embeddings-only text encoder, and the ``full`` joint attention
mask. Names are the reference checkpoint's (``enc_img.swin.*``,
``enc_img.emb_pos``, ``enc_txt.emb_txt.*``, ``trsfr.layer.*``).

``go_feat``, ``go_cross`` and :class:`ScoreHead` take a ``generator``: with
one they run the training pass (stochastic depth, dropout, attention
dropout, all drawn from it), without one the deterministic pass, the JAX
package's ``deterministic`` switch.
"""

from __future__ import annotations

import torch
from torch import nn

from empirical_mvm_torch.core.config import ModelConfig
from empirical_mvm_torch.models.bert import (BertEmbeddings, BertEncoder,
                                             extended_attention_mask)
from empirical_mvm_torch.models.common import Linear, dropout
from empirical_mvm_torch.models.video_swin import SwinTransformer3D
from empirical_mvm_torch.ops.layernorm import FusedLayerNorm
from empirical_mvm_torch.ops.preprocess import maybe_normalize


class EncVideo(nn.Module):
    """Video Swin + projection + per-frame CLS + positional embeddings
    (ref: model.py:8-78).

    Input ``img (B, T, H, W, 3)``, uint8 or normalized float. Output
    ``feat (B, T*(1+h*w), D)`` and ``mask (B, T*(1+h*w))`` with h = H/32,
    w = W/32.
    """

    def __init__(self, cfg: ModelConfig, dtype=torch.float32):
        super().__init__()
        if cfg.swinbert:
            raise NotImplementedError("the SwinBERT video layout is not ported")
        d = cfg.hidden_size
        self.swin = SwinTransformer3D(cfg.swin, dtype)
        self.latent = cfg.swin.num_features
        self.fc = (Linear(self.latent, d, compute_dtype=dtype)
                   if self.latent != d else None)
        self.emb_cls = nn.Parameter(torch.zeros(1, 1, 1, d))
        self.emb_pos = nn.Parameter(torch.zeros(1, 1, 1 + cfg.max_size_patch ** 2, d))
        self.emb_len = nn.Parameter(torch.zeros(1, cfg.max_size_frame, 1, d))
        # frame-order embedding of the pretrain pretext task: kept so that
        # checkpoints load, unused by the eval forward
        self.emb_odr = nn.Parameter(torch.zeros(1, 1, 1, d))
        self.norm = FusedLayerNorm(d, 1e-5)

    def forward(self, img, generator=None):
        img = maybe_normalize(img)
        b, t, hh, ww, _ = img.shape
        hw = (hh // 32) * (ww // 32)
        f = self.swin(img, generator).reshape(b, t, hw, self.latent)
        if self.fc is not None:
            f = self.fc(f)
        d = f.shape[-1]
        cls = self.emb_cls.to(f.dtype).expand(b, t, 1, d)
        f = torch.cat([cls, f], dim=2)                          # (B, T, 1+hw, D)
        f = f + self.emb_pos[:, :, :1 + hw].to(f.dtype)
        f = f + self.emb_len[:, :t].to(f.dtype)
        f = self.norm(f).reshape(b, t * (1 + hw), d)
        m = torch.ones((b, t * (1 + hw)), dtype=torch.int32, device=f.device)
        return f, m


class EncTxt(nn.Module):
    """Text encoder: BERT embeddings only (ref: model.py:80-115, the
    ``txt_backbone_embed_only`` default)."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32):
        super().__init__()
        if not cfg.txt_backbone_embed_only:
            raise NotImplementedError("a text encoder stack is not ported; "
                                      "txt_backbone_embed_only must be true")
        self.emb_txt = BertEmbeddings(cfg.text, dtype)

    def forward(self, txt, generator=None):
        return self.emb_txt(txt, generator)


def joint_attn_bias(mask_img: torch.Tensor, mask_txt: torch.Tensor) -> torch.Tensor:
    """Fusion attention bias over [video ; text] for the ``full`` mask type:
    every token attends every valid token (ref: model.py:180-211)."""
    return extended_attention_mask(torch.cat([mask_img, mask_txt], dim=1))


class ScoreHead(nn.Sequential):
    """Dropout -> Linear(D, 2D) -> ReLU -> Linear(2D, out), the reference's
    ``nn.Sequential`` (names ``fc.1``, ``fc.3``; ref: main_retrieval.py:61).
    The dropout (``self[0].p``) acts only when a generator is passed."""

    def __init__(self, hidden: int, out: int = 1, dtype=torch.float32):
        super().__init__(nn.Dropout(0.1), Linear(hidden, 2 * hidden, compute_dtype=dtype),
                         nn.ReLU(), Linear(2 * hidden, out, compute_dtype=dtype))

    def forward(self, x, generator=None):
        x = dropout(x, self[0].p, generator)
        return self[3](torch.relu(self[1](x)))


class VioletBase(nn.Module):
    """Shared VIOLET trunk (ref: model.py:117-214). ``dtype`` is the compute
    dtype; parameters stay fp32."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32):
        super().__init__()
        if cfg.vis_backbone != "vidswin":
            raise NotImplementedError(f"vis_backbone {cfg.vis_backbone!r} is not ported")
        self.config = cfg
        self.dtype = dtype
        self.enc_img = EncVideo(cfg, dtype)
        self.enc_txt = EncTxt(cfg, dtype)
        self.trsfr = BertEncoder(cfg.fusion, dtype)

    def go_feat(self, img, txt, mask, generator=None):
        """(ref: model.py:174-178)"""
        feat_img, mask_img = self.enc_img(img, generator)
        return feat_img, mask_img, self.enc_txt(txt, generator), mask

    def go_cross(self, feat_img, mask_img, feat_txt, mask_txt, generator=None):
        """(ref: model.py:204-214)"""
        feat = torch.cat([feat_img.to(self.dtype), feat_txt.to(self.dtype)], dim=1)
        return self.trsfr(feat, joint_attn_bias(mask_img, mask_txt), generator)
