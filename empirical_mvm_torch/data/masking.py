"""Pretrain masking, ``rm``, ``bm`` and ``am`` (counterpart of
``empirical_mvm_tpu/data/masking.py``; ref: main_pretrain.py:276-372).

Split in two so that a test can feed the JAX package's draws to the port:

* :func:`draw_masks` draws on an explicit generator on the device: the
  per-sample choice of mask type, the ``rm`` patch cover (Bernoulli(p) over
  the (T, h, w) grid), the ``bm`` cover (a union of T random 3D tubes per
  sample), the text selection (Bernoulli(p) over non-special tokens), which
  ``rm`` and ``bm`` share as the JAX package's do, and for ``am`` the Gumbel
  noise of its draw (:func:`am_cov_and_text`: k = max(floor(L p), 1) slots
  of the fused sequence without replacement, in proportion to the
  attention rollout's scores, none special), which gives ``am`` its own
  cover and text selection;
* :func:`apply_masking` is deterministic given those draws: the MTM answers,
  the ``[MASK]`` substitution, the 32x pixel cover and the masked clip.

Data parallel (``parallel.mesh.data_parallel``), every draw is made at the
global batch's shape from the generator all ranks share, and each rank keeps
its rows, so the ranks together draw what one process draws.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from empirical_mvm_torch.parallel.mesh import global_rows, local_rows

MASK_TYPES = ("rm", "bm", "am")


class MaskDraws(NamedTuple):
    choice: torch.Tensor    # (B,) int64 index into mask_types
    covs: torch.Tensor      # (len(mask_types), B, T, h, w) fp32 patch covers
    # (len(mask_types), B, X) bool: each type's text positions to mask (rm
    # and bm share one selection, am draws its own)
    txt_sel: torch.Tensor


class MaskedBatch(NamedTuple):
    img: torch.Tensor       # (B, T, H, W, 3) masked pixels
    txt: torch.Tensor       # (B, X) with [MASK] substitutions
    ans_mtm: torch.Tensor   # (B, X) original token at masked positions, else -1
    mvm_mask: torch.Tensor  # (B, T, H, W, 1) pixel-space cover in {0, 1}
    cov: torch.Tensor       # (B, T, h, w) patch-space cover in {0, 1}
    ans_mvm: torch.Tensor   # (B, T*(1+h*w)) int32: the vq token where covered, else -1


def _uniform(gen, shape, device):
    return torch.rand(shape, generator=gen, device=device)


def _randint(gen, low, high, shape, device):
    """Integers in [low, high) with a per-element ``high`` (an int64 tensor
    or an int). An int stays a host scalar: a tensor made from it on the
    card would be a blocking copy, a host wait each draw."""
    u = _uniform(gen, shape, device)
    return low + (u * (high - low)).long()


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


def am_special(txt_special: torch.Tensor, t: int, h: int, w: int,
               vq: torch.Tensor | None = None) -> torch.Tensor:
    """(B, T*(1+h*w) + X) bool: the fused slots ``am`` never masks: each
    frame's CLS slot, or with pre-extracted ``vq`` the slots whose token is
    -1, then the special text tokens."""
    b, l = txt_special.shape[0], t * (1 + h * w)
    if vq is not None:
        video = vq == -1
    else:
        slot = torch.arange(l, device=txt_special.device) % (1 + h * w)
        video = (slot == 0).expand(b, l)
    return torch.cat([video, txt_special], dim=1)


def am_cov_and_text(scores: torch.Tensor, special: torch.Tensor, gumbel: torch.Tensor,
                    t: int, h: int, w: int, x_len: int, p: float):
    """The ``am`` draw (JAX ``_am_cov_and_text``; ref: main_pretrain.py:320-343)
    given its Gumbel noise: k = max(floor(L p), 1) of the L fused slots by
    Gumbel top-k on log(max(score, 1e-20)) (sampling without replacement in
    proportion to the rollout's ``scores`` (B, L), the special slots' scores
    taken as 0), the special slots dropped again. Returns the patch cover
    (B, T, h, w) fp32 (each frame's CLS slot left out) and the text
    selection (B, x_len) bool."""
    b, l = scores.shape
    lv = t * (1 + h * w)
    k = max(int(l * p), 1)
    s = torch.where(special, 0.0, scores.float())
    idx = (torch.log(s.clamp(min=1e-20)) + gumbel).topk(k, dim=1).indices
    sel = torch.zeros((b, l), dtype=torch.bool, device=scores.device)
    sel = sel.scatter(1, idx, True) & ~special
    cov = sel[:, :lv].reshape(b, t, 1 + h * w)[:, :, 1:].reshape(b, t, h, w).float()
    return cov, sel[:, lv:lv + x_len]


def gumbel_noise(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(u)) with u uniform in [tiny, 1), as
    ``jax.random.gumbel`` draws it."""
    u = _uniform(gen, shape, device).clamp(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def draw_masks(gen: torch.Generator, txt: torch.Tensor, t: int, h: int, w: int, *,
               special_token_ids: Sequence[int], mask_token_id: int,
               p_mask: float = 0.15, mask_types: Sequence[str] = ("bm", "rm"),
               att_scores: torch.Tensor | None = None,
               vq: torch.Tensor | None = None) -> MaskDraws:
    """The random part of the JAX ``apply_masking``, on ``gen``'s device:
    drawn for the global batch, this rank's rows kept. ``am`` needs
    ``att_scores`` (B, T*(1+h*w) + X), the rollout of this rank's rows
    (``VioletPretrain.get_att``), and takes ``vq``, the pre-extracted tokens
    :func:`apply_masking` gets, for its special slots."""
    for mt in mask_types:
        if mt not in MASK_TYPES:
            raise ValueError(f"unknown mask type {mt!r}")
    b = txt.shape[0]
    dev = txt.device
    if p_mask <= 0:
        return MaskDraws(torch.zeros(b, dtype=torch.int64, device=dev),
                         torch.zeros((len(mask_types), b, t, h, w), device=dev),
                         torch.zeros((len(mask_types), *txt.shape), dtype=torch.bool,
                                     device=dev))
    g = global_rows(b)
    spc = special_tokens(txt, special_token_ids, mask_token_id)
    choice = local_rows(_randint(gen, 0, len(mask_types), (g,), dev))
    shared = None
    if {"rm", "bm"} & set(mask_types):
        shared = (local_rows(_uniform(gen, (g, *txt.shape[1:]), dev)) < p_mask) & ~spc
    covs, sels = [], []
    for mt in mask_types:
        if mt == "rm":
            covs.append(local_rows((_uniform(gen, (g, t, h, w), dev) < p_mask).float()))
        elif mt == "bm":
            tubes = tuple(local_rows(v) for v in bm_tubes(gen, g, t, h, w, dev))
            covs.append(tube_cover(tubes, t, h, w))
        else:
            if att_scores is None:
                raise ValueError("'am' masking requires att_scores")
            noise = local_rows(gumbel_noise(gen, (g, att_scores.shape[1]), dev))
            cov, sel = am_cov_and_text(att_scores, am_special(spc, t, h, w, vq), noise,
                                       t, h, w, txt.shape[1], p_mask)
            covs.append(cov)
            sels.append(sel)
            continue
        sels.append(shared)
    return MaskDraws(choice, torch.stack(covs), torch.stack(sels))


def apply_masking(draws: MaskDraws, img: torch.Tensor, txt: torch.Tensor,
                  vq: torch.Tensor | None = None, *, mask_token_id: int,
                  patch_size: int = 32) -> MaskedBatch:
    """The deterministic part of the JAX ``apply_masking``: pick each sample's
    cover, mask text and pixels. ``vq`` (B, T*(1+h*w)), pre-extracted tokens
    in the fused video-token order (each frame's CLS slot first), gives the
    MVM-vq answers: the token where the patch is covered, -1 elsewhere and at
    every CLS slot (ref: main_pretrain.py:357-361)."""
    b = txt.shape[0]
    rows = torch.arange(b, device=txt.device)
    cov = draws.covs[draws.choice, rows]                                # (B, T, h, w)
    t = cov.shape[1]
    cov_full = torch.cat([cov.new_zeros(b, t, 1), cov.reshape(b, t, -1)], dim=2).reshape(b, -1)
    ans_mvm = (torch.full(cov_full.shape, -1, dtype=torch.int32, device=cov.device)
               if vq is None else torch.where(cov_full > 0, vq, -1).to(torch.int32))
    sel = draws.txt_sel[draws.choice, rows]                             # (B, X)
    ans_mtm = torch.where(sel, txt, -1).to(torch.int32)
    new_txt = torch.where(sel, mask_token_id, txt).to(txt.dtype)
    pix = cov.repeat_interleave(patch_size, 2).repeat_interleave(patch_size, 3)
    pix = pix[..., None].to(img.dtype)                                  # (B, T, H, W, 1)
    return MaskedBatch(img=img * (1.0 - pix), txt=new_txt, ans_mtm=ans_mtm,
                       mvm_mask=pix, cov=cov, ans_mvm=ans_mvm)
