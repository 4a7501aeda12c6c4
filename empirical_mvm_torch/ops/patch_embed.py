"""3D patch embedding as im2col plus one matrix product (counterpart of
``empirical_mvm_tpu/ops/patch_embed.py:25-63``).

The reference's ``Conv3d(kernel=(2,4,4), stride=(1,4,4))`` on a clip padded
by one frame at the end has non-overlapping 4x4 spatial patches and two
temporal taps, so

    out[t] = patches[t] @ W[0] + patches[t+1] @ W[1] + b     (patches[T] = 0)

which is one (B*T*h*w, kd*kh*kw*C) @ (kd*kh*kw*C, E) product. H and W are
padded up to the patch size and T gets the +1 temporal pad, so the output
keeps the input's T.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def patch_embed_3d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   patch_size=(2, 4, 4), dtype=torch.float32) -> torch.Tensor:
    """Args:
      x:      (B, T, H, W, C) clip, channel-last.
      weight: (E, C, kd, kh, kw) conv weight (torch OIDHW layout).
      bias:   (E,).
    Returns:
      (B, T, H//kh, W//kw, E) in ``dtype``. The product takes its operands
      rounded to ``dtype`` and accumulates and adds the bias in fp32, as
      ``jnp.dot(..., preferred_element_type=float32)`` does.
    """
    kd, kh, kw = patch_size
    b, t, h, w, c = x.shape
    x = F.pad(x, (0, 0, 0, (-w) % kw, 0, (-h) % kh))
    hp, wp = x.shape[2], x.shape[3]
    nh, nw = hp // kh, wp // kw

    p = x.reshape(b, t, nh, kh, nw, kw, c)
    p = p.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, t, nh, nw, kh * kw * c)
    # temporal tap k sees frame t+k, zero past the end
    taps = [p] + [F.pad(p[:, k:], (0, 0, 0, 0, 0, 0, 0, k)) for k in range(1, kd)]
    p = torch.cat(taps, dim=-1)                        # (B, T, nh, nw, kd*kh*kw*C)

    wmat = weight.permute(2, 3, 4, 1, 0).reshape(-1, weight.shape[0])
    out = p.to(dtype).float() @ wmat.to(dtype).float()
    return (out + bias.float()).to(dtype)
