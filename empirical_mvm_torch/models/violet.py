"""VIOLET trunk (counterpart of ``empirical_mvm_tpu/models/violet.py``):
video encoder, text embeddings, cross-modal fusion, and the score head.

Covers what the retrieval eval and the pretrain step run: the ``vidswin``
backbone (:class:`EncVideo`), the trained 2D Swin backbone
(``vis_backbone`` ``"swin"`` / ``"swin2d"``: ``encoders2d.EncImgSwin``, mean
or concat fusion), the ResNet-50 (``"r50"``, mean or concat:
``encoders2d.EncImgR50``) and the MERLOT encoder (``"merlot"``, concat:
``encoders2d.EncImgMerlot``), the embeddings-only text encoder, the ``full`` and
``seq2seq`` joint attention masks, and the QA heads' text prefixes (a
learned task token or an encoded prompt, :meth:`VioletBase.prepend_pretxt`). Names are the reference
checkpoint's (``enc_img.swin.*``, ``enc_img.emb_pos``, ``enc_txt.emb_txt.*``,
``trsfr.layer.*``).

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
from empirical_mvm_torch.models.encoders2d import EncImgMerlot, EncImgR50, EncImgSwin
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


ATTN_MASK_TYPES = ("full", "seq2seq")


def joint_attn_bias(mask_img: torch.Tensor, mask_txt: torch.Tensor,
                    attn_mask_type: str = "full") -> torch.Tensor:
    """Fusion attention bias over [video ; text], additive fp32 (ref:
    model.py:180-211 get_attn_mask and the HF mask extension).

    ``full``: every token attends every valid token; (B, 1, 1, L).
    ``seq2seq``: every row attends the valid video tokens, video rows no
    text, text rows the text at or before them (``tril``); (B, 1, L, L).
    As in JAX, ``mask_txt`` does not enter the seq2seq mask: a padded text
    row attends the padding before it, and every row attends at least one
    video token when any video token is valid."""
    if attn_mask_type == "full":
        return extended_attention_mask(torch.cat([mask_img, mask_txt], dim=1))
    if attn_mask_type != "seq2seq":
        raise ValueError(f"attn_mask_type {attn_mask_type!r} is not one of {ATTN_MASK_TYPES}")
    (b, lv), lt = mask_img.shape, mask_txt.shape[1]
    mask = torch.zeros((b, lv + lt, lv + lt), dtype=torch.int32, device=mask_img.device)
    mask[:, :, :lv] = mask_img[:, None, :]
    mask[:, lv:, lv:] = torch.ones((lt, lt), dtype=torch.int32, device=mask_img.device).tril()
    return extended_attention_mask(mask)


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
    dtype; parameters stay fp32. With ``enable_task_token`` the trunk holds
    ``emb_task``, one learned row per task (ref: main_qaoe_lsmdc_fib.py:66-67)."""

    # (ref: main_qaoe_lsmdc_fib.py:65 task_tok2id)
    TASK_TOK2ID = {"vtm": 0, "mc": 1, "oe": 2, "cap": 3}

    def __init__(self, cfg: ModelConfig, dtype=torch.float32):
        super().__init__()
        vb = cfg.vis_backbone
        if vb == "vidswin":
            self.enc_img = EncVideo(cfg, dtype)
        elif vb in ("swin", "swin2d"):
            self.enc_img = EncImgSwin(cfg, cfg.temporal_fusion, dtype)
        elif vb == "r50":
            self.enc_img = EncImgR50(cfg, cfg.temporal_fusion, cfg.r50_train_bn, dtype)
        elif vb == "merlot":
            if cfg.temporal_fusion != "concat":
                raise ValueError("merlot requires temporal_fusion=concat (ref args.py:174)")
            self.enc_img = EncImgMerlot(cfg, cfg.r50_train_bn, dtype=dtype)
        else:
            raise ValueError(f"unknown vis_backbone {vb!r}")
        self.config = cfg
        self.dtype = dtype
        self.enc_txt = EncTxt(cfg, dtype)
        self.trsfr = BertEncoder(cfg.fusion, dtype)
        if cfg.enable_task_token:
            self.emb_task = nn.Parameter(torch.zeros(cfg.num_task_tokens, cfg.hidden_size))

    def go_feat(self, img, txt, mask, generator=None):
        """(ref: model.py:174-178)"""
        feat_img, mask_img = self.enc_img(img, generator)
        return feat_img, mask_img, self.enc_txt(txt, generator), mask

    def prepend_pretxt(self, mask_txt, feat_txt, prompt=None, generator=None):
        """Prepend the task token's row (``enable_task_token``) or an encoded
        text prompt (``enable_prompt`` and a ``prompt`` (tokens, mask), each
        (P,) or (B, P)) to the text features and their mask (ref:
        model.py:219-258). Returns (mask_txt, feat_txt, prefix length), so
        that a caller can slice its logits back to the text positions; with
        neither, the inputs and 0. (The JAX version also threads a label row
        through the concatenation, which its one caller discards.)"""
        cfg = self.config
        b, d = mask_txt.shape[0], feat_txt.shape[-1]
        if cfg.enable_task_token:
            row = self.emb_task[self.TASK_TOK2ID[cfg.task_token]]
            pre_feat = row.to(feat_txt.dtype).expand(b, 1, d)
            pre_mask = torch.ones((b, 1), dtype=mask_txt.dtype, device=mask_txt.device)
        elif cfg.enable_prompt and prompt is not None:
            p_txt, p_mask = prompt
            if p_txt.ndim == 1:
                p_txt, p_mask = p_txt.expand(b, -1), p_mask.expand(b, -1)
            pre_feat = self.enc_txt(p_txt, generator).to(feat_txt.dtype)
            pre_mask = p_mask.to(mask_txt.dtype)
        else:
            return mask_txt, feat_txt, 0
        return (torch.cat([pre_mask, mask_txt], dim=1), torch.cat([pre_feat, feat_txt], dim=1),
                pre_mask.shape[1])

    def go_cross(self, feat_img, mask_img, feat_txt, mask_txt, generator=None,
                 attn_mask_type="full"):
        """(ref: model.py:204-214) The fusion over [video ; text] under the
        ``attn_mask_type`` joint mask (:func:`joint_attn_bias`)."""
        feat = torch.cat([feat_img.to(self.dtype), feat_txt.to(self.dtype)], dim=1)
        return self.trsfr(feat, joint_attn_bias(mask_img, mask_txt, attn_mask_type), generator)
