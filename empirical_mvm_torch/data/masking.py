"""Pretrain masking, ``rm`` and ``bm`` (counterpart of
``empirical_mvm_tpu/data/masking.py``; ref: main_pretrain.py:276-372).

Split in two so that a test can feed the JAX package's draws to the port:

* :func:`draw_masks` draws on an explicit generator on the device: the
  per-sample choice of mask type, the ``rm`` patch cover (Bernoulli(p) over
  the (T, h, w) grid), the ``bm`` cover (a union of T random 3D tubes per
  sample), and the text selection (Bernoulli(p) over non-special tokens),
  which both mask types share as the JAX package's do;
* :func:`apply_masking` is deterministic given those draws: the MTM answers,
  the ``[MASK]`` substitution, the 32x pixel cover and the masked clip.

``am`` masking needs per-layer attentions and is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

MASK_TYPES = ("rm", "bm")


class MaskDraws(NamedTuple):
    choice: torch.Tensor    # (B,) int64 index into mask_types
    covs: torch.Tensor      # (len(mask_types), B, T, h, w) fp32 patch covers
    txt_sel: torch.Tensor   # (B, X) bool: text positions to mask


class MaskedBatch(NamedTuple):
    img: torch.Tensor       # (B, T, H, W, 3) masked pixels
    txt: torch.Tensor       # (B, X) with [MASK] substitutions
    ans_mtm: torch.Tensor   # (B, X) original token at masked positions, else -1
    mvm_mask: torch.Tensor  # (B, T, H, W, 1) pixel-space cover in {0, 1}
    cov: torch.Tensor       # (B, T, h, w) patch-space cover in {0, 1}


def _uniform(gen, shape, device):
    return torch.rand(shape, generator=gen, device=device)


def _randint(gen, low, high, shape, device):
    """Integers in [low, high) with a per-element ``high`` (an int64 tensor
    or an int)."""
    u = _uniform(gen, shape, device)
    return low + (u * (torch.as_tensor(high, device=device) - low)).long()


def bm_tubes(gen: torch.Generator, b: int, t: int, h: int, w: int, device):
    """T tubes per sample (ref: main_pretrain.py:308-318): sizes
    bt ~ U[1, max(T,2)) (1 when T = 1), bh ~ U[1, max(2h//3, 2)),
    bw ~ U[1, max(2w//3, 2)), and starts so the tube lies inside the grid.
    Returns (t1, bt, h1, bh, w1, bw), each (B, T) int64."""
    shape = (b, t)
    bt = (_randint(gen, 1, max(t, 2), shape, device) if t > 1
          else torch.ones(shape, dtype=torch.int64, device=device))
    bh = _randint(gen, 1, max(h * 2 // 3, 2), shape, device)
    bw = _randint(gen, 1, max(w * 2 // 3, 2), shape, device)
    t1 = _randint(gen, 0, t - bt + 1, shape, device)
    h1 = _randint(gen, 0, h - bh + 1, shape, device)
    w1 = _randint(gen, 0, w - bw + 1, shape, device)
    return t1, bt, h1, bh, w1, bw


def tube_cover(tubes, t: int, h: int, w: int) -> torch.Tensor:
    """(B, T, h, w) fp32 union of the tubes from :func:`bm_tubes`."""
    t1, bt, h1, bh, w1, bw = (v[..., None, None, None] for v in tubes)
    dev = t1.device
    it = torch.arange(t, device=dev).view(t, 1, 1)
    ih = torch.arange(h, device=dev).view(1, h, 1)
    iw = torch.arange(w, device=dev).view(1, 1, w)
    inside = ((it >= t1) & (it < t1 + bt) & (ih >= h1) & (ih < h1 + bh)
              & (iw >= w1) & (iw < w1 + bw))               # (B, T tubes, t, h, w)
    return inside.any(dim=1).float()


def special_tokens(txt: torch.Tensor, special_token_ids: Sequence[int],
                   mask_token_id: int) -> torch.Tensor:
    """Positions never masked: the special ids and [MASK] itself."""
    spc = txt == mask_token_id
    for tok in special_token_ids:
        spc = spc | (txt == tok)
    return spc


def draw_masks(gen: torch.Generator, txt: torch.Tensor, t: int, h: int, w: int, *,
               special_token_ids: Sequence[int], mask_token_id: int,
               p_mask: float = 0.15, mask_types: Sequence[str] = ("bm", "rm")) -> MaskDraws:
    """The random part of the JAX ``apply_masking`` for ``rm`` and ``bm``,
    on ``gen``'s device."""
    for mt in mask_types:
        if mt not in MASK_TYPES:
            raise NotImplementedError(f"mask type {mt!r} is not ported")
    b = txt.shape[0]
    dev = txt.device
    if p_mask <= 0:
        return MaskDraws(torch.zeros(b, dtype=torch.int64, device=dev),
                         torch.zeros((len(mask_types), b, t, h, w), device=dev),
                         torch.zeros(txt.shape, dtype=torch.bool, device=dev))
    choice = _randint(gen, 0, len(mask_types), (b,), dev)
    txt_sel = (_uniform(gen, txt.shape, dev) < p_mask) & ~special_tokens(
        txt, special_token_ids, mask_token_id)
    covs = []
    for mt in mask_types:
        if mt == "rm":
            covs.append((_uniform(gen, (b, t, h, w), dev) < p_mask).float())
        else:
            covs.append(tube_cover(bm_tubes(gen, b, t, h, w, dev), t, h, w))
    return MaskDraws(choice, torch.stack(covs), txt_sel)


def apply_masking(draws: MaskDraws, img: torch.Tensor, txt: torch.Tensor, *,
                  mask_token_id: int, patch_size: int = 32) -> MaskedBatch:
    """The deterministic part of the JAX ``apply_masking``: pick each sample's
    cover, mask text and pixels."""
    b = txt.shape[0]
    cov = draws.covs[draws.choice, torch.arange(b, device=txt.device)]   # (B, T, h, w)
    sel = draws.txt_sel
    ans_mtm = torch.where(sel, txt, -1).to(torch.int32)
    new_txt = torch.where(sel, mask_token_id, txt).to(txt.dtype)
    pix = cov.repeat_interleave(patch_size, 2).repeat_interleave(patch_size, 3)
    pix = pix[..., None].to(img.dtype)                                  # (B, T, H, W, 1)
    return MaskedBatch(img=img * (1.0 - pix), txt=new_txt, ans_mtm=ans_mtm,
                       mvm_mask=pix, cov=cov)
