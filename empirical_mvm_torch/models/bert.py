"""BERT blocks for the text embeddings, the cross-modal fusion encoder and
the MLM head (counterpart of ``empirical_mvm_tpu/models/bert.py``).

Module and parameter names are HF BERT's (``attention.self.query``,
``attention.output.LayerNorm``, ``intermediate.dense``,
``predictions.transform.dense``, ...), the names of the reference
checkpoints. Attention runs through :func:`lane_self_attention` on one fused
qkv product, and every LayerNorm through :func:`fused_layer_norm`.

Training: a generator passed to ``forward`` turns on hidden dropout at the
JAX package's sites (after the embeddings' LayerNorm, after the attention
output projection, after the layer's output projection) and the
attention-probability dropout inside the attention kernel. No generator is
the deterministic pass.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from empirical_mvm_torch.core.config import BertConfig
from empirical_mvm_torch.models.common import Linear, dropout
from empirical_mvm_torch.ops.layernorm import FusedLayerNorm
from empirical_mvm_torch.ops.window_attention import lane_self_attention


def extended_attention_mask(mask: torch.Tensor,
                            dtype=torch.float32) -> torch.Tensor:
    """(B, L) or (B, Lq, Lk) 0/1 mask -> additive (B, 1, Lq or 1, Lk) bias:
    0 where allowed, float32 min where masked (HF
    ``get_extended_attention_mask``, ref model.py:211)."""
    if mask.ndim == 2:
        m = mask[:, None, None, :]
    elif mask.ndim == 3:
        m = mask[:, None, :, :]
    else:
        raise ValueError(f"mask ndim {mask.ndim}")
    return ((1.0 - m.float()) * torch.finfo(torch.float32).min).to(dtype)


class BertEmbeddings(nn.Module):
    """Word + position + token-type embeddings, LayerNorm (HF BertEmbeddings).
    The sum and the LayerNorm run in fp32; the output is cast to ``dtype``."""

    def __init__(self, cfg: BertConfig, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.p_drop = cfg.hidden_dropout_prob
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.LayerNorm = FusedLayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, input_ids, generator=None):
        ids = input_ids.long()
        pos = torch.arange(ids.shape[1], device=ids.device)[None]
        x = (self.word_embeddings(ids) + self.position_embeddings(pos)
             + self.token_type_embeddings(torch.zeros_like(ids)))
        return dropout(self.LayerNorm(x), self.p_drop, generator).to(self.dtype)


class _QKV(nn.Module):
    """HF ``attention.self``: separate query/key/value parameters."""

    def __init__(self, d: int, dtype):
        super().__init__()
        self.query = Linear(d, d, compute_dtype=dtype)
        self.key = Linear(d, d, compute_dtype=dtype)
        self.value = Linear(d, d, compute_dtype=dtype)


class _Output(nn.Module):
    """HF ``*.output``: dense, hidden dropout, then LayerNorm of
    (dense + residual)."""

    def __init__(self, d_in: int, d: int, eps: float, dtype, p_drop: float):
        super().__init__()
        self.p_drop = p_drop
        self.dense = Linear(d_in, d, compute_dtype=dtype)
        self.LayerNorm = FusedLayerNorm(d, eps)

    def forward(self, h, residual, generator=None):
        return self.LayerNorm(dropout(self.dense(h), self.p_drop, generator) + residual)


class BertSelfAttention(nn.Module):
    """Multi-head self-attention + output projection + residual LayerNorm
    (HF BertAttention; JAX ``BertSelfAttention``). q, k and v keep their own
    parameters and run as one product of the concatenated weights, as
    bert.py:118-120 of the JAX package does."""

    def __init__(self, cfg: BertConfig, dtype=torch.float32):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.p_attn = cfg.attention_probs_dropout_prob
        self.dtype = dtype
        self.self = _QKV(d, dtype)
        self.output = _Output(d, d, cfg.layer_norm_eps, dtype, cfg.hidden_dropout_prob)

    def forward(self, x, mask, generator=None):
        """x (B, L, D); mask (B, L, L) fp32 additive (may be a broadcast view)."""
        s, dt = self.self, self.dtype
        w3 = torch.cat([s.query.weight, s.key.weight, s.value.weight]).to(dt)
        b3 = torch.cat([s.query.bias, s.key.bias, s.value.bias]).to(dt)
        qkv = F.linear(x.to(dt), w3, b3)                         # (B, L, 3D)
        hd = x.shape[-1] // self.num_heads
        ctx = lane_self_attention(qkv, mask, self.num_heads, hd ** -0.5,
                                  self.p_attn if generator is not None else 0.0,
                                  generator)
        return self.output(ctx, x, generator)


class BertLayer(nn.Module):
    """One transformer layer (HF BertLayer)."""

    def __init__(self, cfg: BertConfig, dtype=torch.float32):
        super().__init__()
        self.attention = BertSelfAttention(cfg, dtype)
        self.intermediate = nn.Module()
        self.intermediate.dense = Linear(cfg.hidden_size, cfg.intermediate_size,
                                         compute_dtype=dtype)
        self.output = _Output(cfg.intermediate_size, cfg.hidden_size,
                              cfg.layer_norm_eps, dtype, cfg.hidden_dropout_prob)

    def forward(self, x, mask, generator=None):
        x = self.attention(x, mask, generator)
        return self.output(F.gelu(self.intermediate.dense(x)), x, generator)


class BertEncoder(nn.Module):
    """Stack of BertLayers (HF BertEncoder): the fusion ``trsfr``."""

    def __init__(self, cfg: BertConfig, dtype=torch.float32):
        super().__init__()
        self.layer = nn.ModuleList([BertLayer(cfg, dtype)
                                    for _ in range(cfg.num_hidden_layers)])

    def forward(self, x, attn_bias=None, generator=None):
        """attn_bias: additive (B, 1, 1 or L, L) fp32 from
        :func:`extended_attention_mask`, or None."""
        b, l = x.shape[:2]
        if attn_bias is None:
            mask = torch.zeros((b, l, l), dtype=torch.float32, device=x.device)
        else:
            mask = attn_bias.float().reshape(b, *attn_bias.shape[2:]).expand(b, l, l)
        for layer in self.layer:
            x = layer(x, mask, generator)
        return x


class BertMLMHead(nn.Module):
    """HF ``BertOnlyMLMHead``: transform dense, exact GELU, LayerNorm, vocab
    decoder (JAX ``BertMLMHead``; the reference's ``fc_mtm``,
    main_pretrain.py:148-150)."""

    def __init__(self, cfg: BertConfig, dtype=torch.float32):
        super().__init__()
        d = cfg.hidden_size
        self.predictions = nn.Module()
        self.predictions.transform = nn.Module()
        self.predictions.transform.dense = Linear(d, d, compute_dtype=dtype)
        self.predictions.transform.LayerNorm = FusedLayerNorm(d, cfg.layer_norm_eps)
        self.predictions.decoder = Linear(d, cfg.vocab_size, compute_dtype=dtype)

    def forward(self, x):
        t = self.predictions.transform
        return self.predictions.decoder(t.LayerNorm(F.gelu(t.dense(x))))
