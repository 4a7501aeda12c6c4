"""Frozen CLIP ViT visual encoder, the teacher of the ``2d_clip`` MVM target
(counterpart of ``empirical_mvm_tpu/teachers/clip.py``).

The standard CLIP vision tower (ViT-B/32 by default) with the parameter
names of the HF ``CLIPVisionModel``'s ``vision_model`` (``embeddings.
patch_embedding.weight``, ``pre_layrnorm``, spelled as HF spells it,
``encoder.layers.{i}.self_attn.q_proj``, ``layer_norm1``, ``mlp.fc1``,
``post_layernorm``), so a HF checkpoint's vision tower loads as it is and
the JAX ``clip_params_from_torch`` reads the port's state_dict. q, k and v
keep HF's three projections and run as one product of the concatenated
weights, as the JAX ``qkv`` Dense does.

As in the JAX package (``use_pallas=True``, the frozen-teacher policy):
channel-last input, the patch conv (stride = kernel, no bias) as a reshape
and one GEMM, pre-LN layers with quick-GELU MLPs, every LayerNorm through
the kernel (:class:`FusedLayerNorm`), and attention routed by
:func:`lane_sa_attention_fits`: :func:`lane_self_attention` (p = 0, a zero
mask) where it fits, at ViT-B/32's 50 tokens of width 768, else
:func:`packed_self_attention`. At 224^2 the 7 x 7 patch grid is the
student's fused-token grid, so :meth:`CLIPVisual.features` is the target
with no resampling.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from empirical_mvm_torch.models.common import Linear
from empirical_mvm_torch.ops.layernorm import FusedLayerNorm
from empirical_mvm_torch.ops.window_attention import vit_self_attention

# CLIP's own input normalization (OpenAI CLIP preprocessing); the pipeline
# ships ImageNet-normalized clips
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def renormalize_imagenet_to_clip(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) ImageNet-normalized -> CLIP-normalized, in x's dtype."""
    im_m, im_s, cl_m, cl_s = (torch.tensor(v, dtype=x.dtype, device=x.device)
                              for v in (IMAGENET_MEAN, IMAGENET_STD, CLIP_MEAN, CLIP_STD))
    return (x * im_s + im_m - cl_m) / cl_s


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """OpenAI CLIP activation: x * sigmoid(1.702 x) (HF "quick_gelu")."""
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    """HF ``self_attn``: q, k, v and out projections."""

    def __init__(self, dim: int, num_heads: int, dtype):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.q_proj = Linear(dim, dim, compute_dtype=dtype)
        self.k_proj = Linear(dim, dim, compute_dtype=dtype)
        self.v_proj = Linear(dim, dim, compute_dtype=dtype)
        self.out_proj = Linear(dim, dim, compute_dtype=dtype)

    def forward(self, x):
        dt = self.dtype
        w3 = torch.cat([self.q_proj.weight, self.k_proj.weight, self.v_proj.weight]).to(dt)
        b3 = torch.cat([self.q_proj.bias, self.k_proj.bias, self.v_proj.bias]).to(dt)
        qkv = F.linear(x.to(dt), w3, b3)                                  # (B, L, 3D)
        return self.out_proj(vit_self_attention(qkv, self.num_heads))


class CLIPMLP(nn.Module):
    def __init__(self, dim: int, mlp_dim: int, dtype):
        super().__init__()
        self.fc1 = Linear(dim, mlp_dim, compute_dtype=dtype)
        self.fc2 = Linear(mlp_dim, dim, compute_dtype=dtype)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPLayer(nn.Module):
    """One pre-LN CLIP encoder layer (HF ``CLIPEncoderLayer``)."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int, eps: float = 1e-5,
                 dtype=torch.float32):
        super().__init__()
        self.layer_norm1 = FusedLayerNorm(dim, eps)
        self.self_attn = CLIPAttention(dim, num_heads, dtype)
        self.layer_norm2 = FusedLayerNorm(dim, eps)
        self.mlp = CLIPMLP(dim, mlp_dim, dtype)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPVisual(nn.Module):
    """CLIP vision tower (HF ``CLIPVisionModel`` semantics), ViT-B/32 by
    default. Parameters fp32, products in ``dtype``."""

    def __init__(self, hidden_size: int = 768, num_layers: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, patch_size: int = 32, eps: float = 1e-5,
                 image_size: int = 224, dtype=torch.float32):
        super().__init__()
        self.patch_size, self.hidden_size, self.dtype = patch_size, hidden_size, dtype
        grid = image_size // patch_size
        self.embeddings = nn.Module()
        self.embeddings.patch_embedding = nn.Conv2d(3, hidden_size, patch_size, patch_size,
                                                    bias=False)
        self.embeddings.class_embedding = nn.Parameter(torch.zeros(hidden_size))
        self.embeddings.position_embedding = nn.Embedding(1 + grid * grid, hidden_size)
        self.pre_layrnorm = FusedLayerNorm(hidden_size, eps)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            CLIPLayer(hidden_size, num_heads, mlp_dim, eps, dtype) for _ in range(num_layers))
        self.post_layernorm = FusedLayerNorm(hidden_size, eps)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 3) CLIP-normalized, channel-last -> the last hidden
        state (B, 1 + h*w, D), before the post LayerNorm."""
        b, hh, ww, c = x.shape
        ps, d, dt = self.patch_size, self.hidden_size, self.dtype
        h, w = hh // ps, ww // ps
        emb = self.embeddings
        # the patch conv as one GEMM over (i, j, c)-ordered patches
        kernel = emb.patch_embedding.weight.permute(0, 2, 3, 1).reshape(d, ps * ps * c)
        patches = x.reshape(b, h, ps, w, ps, c).permute(0, 1, 3, 2, 4, 5)
        tok = F.linear(patches.reshape(b, h * w, ps * ps * c).to(dt), kernel.to(dt))
        cls = emb.class_embedding.to(dt).expand(b, 1, d)
        tok = torch.cat([cls, tok], dim=1) + emb.position_embedding.weight.to(dt)
        tok = self.pre_layrnorm(tok)
        for layer in self.encoder.layers:
            tok = layer(tok)
        return tok

    def forward(self, x: torch.Tensor):
        """HF's ``(last_hidden_state, pooled_output)``: the post LayerNorm
        applies to the pooled CLS token only."""
        tok = self.encode(x)
        return tok, self.post_layernorm(tok[:, 0])

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The patch-token grid (B, h, w, D), the 2d_clip target. The pooled
        output is not computed (under ``jit`` the JAX package drops it as
        dead code)."""
        b, ps = x.shape[0], self.patch_size
        tok = self.encode(x)
        return tok[:, 1:].reshape(b, x.shape[1] // ps, x.shape[2] // ps, self.hidden_size)
