"""Frozen DALL-E dVAE encoder, the teacher of the ``vq`` MVM target when its
tokens are extracted in the step (counterpart of
``empirical_mvm_tpu/teachers/dvae.py``; ref: visbackbone/dalle/encoder.py:
13-96, utils.py:46, __init__.py:44-58, 184-190; main_pretrain.py:480-496).

The encoder maps [0, 1] pixels (``map_pixels``) through a 7x7 conv, four
groups of residual blocks at n_hid, 2, 4 and 8 n_hid channels with a 2x2
max-pool between groups, a ReLU and a 1x1 conv to ``vocab_size`` logits at
1/8 of the input's side; the token of a cell is the argmax. Channel-last,
the products in the model dtype and the output conv in fp32, as in the JAX
package. The parameters carry the DALL-E checkpoint's names
(``blocks.input.w``, ``blocks.group_{g}.block_{i}.res_path.conv_{j}.b``,
``blocks.output.conv.w``), so the JAX ``dvae_params_from_torch`` reads the
port's state_dict.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

LOGIT_LAPLACE_EPS = 0.1
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# the encoder's downsampling: one token per VQ_PATCH x VQ_PATCH pixels
VQ_PATCH = 8
# frames whose fp32 logits (B, 28, 28, 8192 at 224^2: 26 MB a frame) one
# output product holds before its argmax
LOGIT_CHUNK_FRAMES = 8


def map_pixels(x: torch.Tensor) -> torch.Tensor:
    """(ref: visbackbone/dalle/utils.py:46)"""
    return (1 - 2 * LOGIT_LAPLACE_EPS) * x + LOGIT_LAPLACE_EPS


def unnormalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalized (..., 3) back to [0, 1] pixels, in x's dtype
    (ref: visbackbone/dalle/__init__.py:184-190)."""
    std, mean = (torch.tensor(v, dtype=x.dtype, device=x.device)
                 for v in (IMAGENET_STD, IMAGENET_MEAN))
    return x * std + mean


class DvaeConv(nn.Module):
    """DALL-E's ``Conv2d``: weight ``w`` (O, I, k, k) and bias ``b``, stride
    1, same padding; channel-last, products in ``dtype``."""

    def __init__(self, n_in: int, n_out: int, kw: int, dtype=torch.float32):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(n_out, n_in, kw, kw))
        self.b = nn.Parameter(torch.zeros(n_out))
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.w.to(dt), self.b.to(dt),
                     padding=(self.w.shape[-1] - 1) // 2)
        return y.permute(0, 2, 3, 1)


class EncoderBlock(nn.Module):
    """(ref: encoder.py:13-39): an identity path (a 1x1 conv where the width
    changes) plus post_gain = 1 / n_layers^2 times the residual path
    relu -> 3x3 -> relu -> 3x3 -> relu -> 3x3 -> relu -> 1x1 at n_out / 4."""

    def __init__(self, n_in: int, n_out: int, n_layers: int, dtype=torch.float32):
        super().__init__()
        n_hid = n_out // 4
        self.post_gain = 1.0 / n_layers ** 2
        if n_in != n_out:
            self.id_path = DvaeConv(n_in, n_out, 1, dtype)
        self.res_path = nn.Module()
        for j, (a, b, k) in enumerate(((n_in, n_hid, 3), (n_hid, n_hid, 3),
                                       (n_hid, n_hid, 3), (n_hid, n_out, 1)), start=1):
            self.res_path.add_module(f"conv_{j}", DvaeConv(a, b, k, dtype))

    def forward(self, x):
        idp = self.id_path(x) if hasattr(self, "id_path") else x
        h = x
        for conv in self.res_path.children():
            h = conv(torch.relu(h))
        return idp + self.post_gain * h


class DvaeEncoder(nn.Module):
    """(ref: encoder.py:42-96) Input (B, H, W, 3) pixels already mapped by
    :func:`map_pixels`; :meth:`forward` gives (B, H/8, W/8, vocab) fp32
    logits. Parameters fp32, products in ``dtype``."""

    def __init__(self, n_hid: int = 256, n_blk_per_group: int = 2, vocab_size: int = 8192,
                 dtype=torch.float32):
        super().__init__()
        n_layers = 4 * n_blk_per_group
        self.blocks = nn.Module()
        self.blocks.input = DvaeConv(3, n_hid, 7, dtype)
        n_in = n_hid
        for g, mult in enumerate((1, 2, 4, 8), start=1):
            group = nn.Module()
            for i in range(1, n_blk_per_group + 1):
                group.add_module(f"block_{i}",
                                 EncoderBlock(n_in, mult * n_hid, n_layers, dtype))
                n_in = mult * n_hid
            self.blocks.add_module(f"group_{g}", group)
        self.blocks.output = nn.Module()
        self.blocks.output.conv = DvaeConv(n_in, vocab_size, 1)

    def features(self, x):
        """The output conv's input: the groups, pooled between, and the ReLU."""
        x = self.blocks.input(x)
        for g in range(1, 5):
            for block in getattr(self.blocks, f"group_{g}").children():
                x = block(x)
            if g < 4:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        return torch.relu(x)

    def forward(self, x):
        return self.blocks.output.conv(self.features(x))

    def extract_vq_tokens(self, img_normalized: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) ImageNet-normalized -> (B, H/8, W/8) int64 tokens
        (the JAX ``DvaeTeacher.extract_vq_tokens``): unnormalized in fp32,
        clipped to [0, 1], mapped, encoded, argmax over the vocabulary (the
        first of equal maxima, as ``jnp.argmax``). The fp32 logits of
        ``LOGIT_CHUNK_FRAMES`` frames at a time live only until their
        argmax."""
        x = map_pixels(unnormalize_imagenet(img_normalized.float()).clamp(0.0, 1.0))
        feats = self.features(x)
        out = self.blocks.output.conv
        return torch.cat([out(f).argmax(-1) for f in feats.split(LOGIT_CHUNK_FRAMES)])
