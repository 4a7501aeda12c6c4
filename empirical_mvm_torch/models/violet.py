"""VIOLET trunk (counterpart of ``empirical_mvm_tpu/models/violet.py``):
video encoder, text embeddings, cross-modal fusion, and the score head.

Covers every variant the JAX package builds: the ``vidswin`` backbone
(:class:`EncVideo`, in VIOLET's layout or, with ``swinbert``, SwinBERT's),
the trained 2D Swin backbone (``vis_backbone`` ``"swin"`` / ``"swin2d"``:
``encoders2d.EncImgSwin``, mean or concat fusion), the ResNet-50 (``"r50"``,
mean or concat: ``encoders2d.EncImgR50``) and the MERLOT encoder
(``"merlot"``, concat: ``encoders2d.EncImgMerlot``), the text encoder
(embeddings only, or with ``txt_backbone_embed_only`` false a BERT stack over
them), the ``full`` and ``seq2seq`` joint attention masks, and the QA heads'
text prefixes (a learned task token or an encoded prompt,
:meth:`VioletBase.prepend_pretxt`). Names are the reference checkpoint's
(``enc_img.swin.*``, ``enc_img.emb_pos``, ``enc_txt.emb_txt.*``,
``enc_txt.txt_trsfr.layer.*``, ``trsfr.layer.*``).

``go_feat``, ``go_cross`` and :class:`ScoreHead` take a ``generator``: with
one they run the training pass (stochastic depth, dropout, attention
dropout, all drawn from it), without one the deterministic pass, the JAX
package's ``deterministic`` switch. They open the tracer's spans
``violet.feat`` and ``violet.cross`` (``core/tracing.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from empirical_mvm_torch.core import tracing
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
    ``feat (B, T*(1+h*w), D)`` and ``mask (B, T*(1+h*w))`` int32 with h =
    H/32, w = W/32. ``odr`` (B, T), the frame-order pretext's permutation,
    gives a frame at its own slot its temporal embedding ``emb_len`` and a
    moved frame ``emb_odr`` (ref: model.py:61-68); ``vt_mask``, broadcast
    over (B, T, 1+h*w), multiplies the mask.

    With ``swinbert`` the layout is SwinBERT's (ref: model.py:27-29, 44-56):
    ``fc`` maps the latent to 512 and ``img_embedding`` 512 to the hidden
    size, and each frame's first token is a zero "fake CLS" whose mask is 0;
    there are no embeddings and no norm, and ``odr`` is not read.
    """

    def __init__(self, cfg: ModelConfig, dtype=torch.float32):
        super().__init__()
        d = cfg.hidden_size
        self.swinbert = cfg.swinbert
        self.swin = SwinTransformer3D(cfg.swin, dtype)
        self.latent = cfg.swin.num_features
        if cfg.swinbert:
            self.fc = Linear(self.latent, 512, compute_dtype=dtype)
            self.img_embedding = Linear(512, d, compute_dtype=dtype)
            return
        self.fc = (Linear(self.latent, d, compute_dtype=dtype)
                   if self.latent != d else None)
        self.emb_cls = nn.Parameter(torch.zeros(1, 1, 1, d))
        self.emb_pos = nn.Parameter(torch.zeros(1, 1, 1 + cfg.max_size_patch ** 2, d))
        self.emb_len = nn.Parameter(torch.zeros(1, cfg.max_size_frame, 1, d))
        self.emb_odr = nn.Parameter(torch.zeros(1, 1, 1, d))
        self.norm = FusedLayerNorm(d, 1e-5)

    def forward(self, img, generator=None, *, odr=None, vt_mask=None):
        img = maybe_normalize(img)
        b, t, hh, ww, _ = img.shape
        hw = (hh // 32) * (ww // 32)
        f = self.swin(img, generator).reshape(b, t, hw, self.latent)
        m = torch.ones((b, t, 1 + hw), dtype=torch.int32, device=f.device)
        if self.swinbert:
            f = self.img_embedding(self.fc(f))
            f = torch.cat([f.new_zeros(b, t, 1, f.shape[-1]), f], dim=2)
            m[:, :, 0] = 0
        else:
            if self.fc is not None:
                f = self.fc(f)
            cls = self.emb_cls.to(f.dtype).expand(b, t, 1, f.shape[-1])
            f = torch.cat([cls, f], dim=2)                      # (B, T, 1+hw, D)
            f = f + self.emb_pos[:, :, :1 + hw].to(f.dtype)
            emb = self.emb_len[:, :t]
            if odr is not None:
                in_place = odr == torch.arange(t, device=odr.device)       # (B, T)
                emb = torch.where(in_place[:, :, None, None], emb, self.emb_odr)
            f = self.norm(f + emb.to(f.dtype))
        if vt_mask is not None:
            m = m * vt_mask.to(m.dtype)
        return f.reshape(b, t * (1 + hw), f.shape[-1]), m.reshape(b, t * (1 + hw))


class EncTxt(nn.Module):
    """Text encoder (ref: model.py:80-115): BERT embeddings and, with
    ``txt_backbone_embed_only`` false, a ``BertEncoder(cfg.text)`` stack over
    them (``txt_trsfr``). The stack attends under ``mask_txt`` (all ones if
    None) for ``full``, and causally (``tril`` over the text, the mask not
    read) for ``seq2seq``, as the JAX ``EncTxt`` builds it."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32):
        super().__init__()
        self.emb_txt = BertEmbeddings(cfg.text, dtype)
        self.txt_trsfr = None if cfg.txt_backbone_embed_only else BertEncoder(cfg.text, dtype)

    def forward(self, txt, generator=None, *, mask_txt=None, attn_mask_type="full"):
        f = self.emb_txt(txt, generator)
        if self.txt_trsfr is None:
            return f
        if attn_mask_type == "seq2seq":
            lt = txt.shape[1]
            m = torch.ones((lt, lt), dtype=torch.int32, device=txt.device).tril()
            m = m.expand(txt.shape[0], lt, lt)
        else:
            m = torch.ones_like(txt) if mask_txt is None else mask_txt
        return self.txt_trsfr(f, extended_attention_mask(m), generator)


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

    def go_feat(self, img, txt, mask, generator=None, *, odr=None, vt_mask=None,
                attn_mask_type="full"):
        """(ref: model.py:174-178) The video tokens and their mask (``odr``
        and ``vt_mask`` to the image encoder) and the text features, the
        text stack attending under ``mask`` and ``attn_mask_type``."""
        with tracing.span("violet.feat"):
            feat_img, mask_img = self.enc_img(img, generator, odr=odr, vt_mask=vt_mask)
            feat_txt = self.enc_txt(txt, generator, mask_txt=mask, attn_mask_type=attn_mask_type)
        return feat_img, mask_img, feat_txt, mask

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
            pre_feat = self.enc_txt(p_txt, generator, mask_txt=p_mask).to(feat_txt.dtype)
            pre_mask = p_mask.to(mask_txt.dtype)
        else:
            return mask_txt, feat_txt, 0
        return (torch.cat([pre_mask, mask_txt], dim=1), torch.cat([pre_feat, feat_txt], dim=1),
                pre_mask.shape[1])

    def go_cross(self, feat_img, mask_img, feat_txt, mask_txt, generator=None,
                 attn_mask_type="full"):
        """(ref: model.py:204-214) The fusion over [video ; text] under the
        ``attn_mask_type`` joint mask (:func:`joint_attn_bias`)."""
        with tracing.span("violet.cross"):
            feat = torch.cat([feat_img.to(self.dtype), feat_txt.to(self.dtype)], dim=1)
            return self.trsfr(feat, joint_attn_bias(mask_img, mask_txt, attn_mask_type),
                              generator)
