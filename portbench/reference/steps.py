"""The plain reference of the pretrain step and the two-stage retrieval eval:
masking and negative draws, losses, backward, gradient clipping and AdamW,
as ``empirical_mvm_torch`` defines them as of commit affdfaf9
(``data/masking.py``, ``models/pretrain.py``, ``train/losses.py``,
``train/optimizer.py``, ``train/train_step.py``, ``train/evaluators.py``).

A step takes the generators the program's step would draw from, made from
(seed, step) by :func:`step_generators`, so its masks, negatives and
dropouts are the program's; nothing else of the program enters.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from portbench.reference import targets
from portbench.reference.model import LayerNorm, normalize

SPECIAL_TOKENS = (101, 102, 0)      # [CLS], [SEP], [PAD]
MASK_TOKEN = 103
EPS = 1e-8
TASKS = ("vtm", "mtm", "mvm")
MASKS = ("rm", "bm")


def check_supported(run: dict) -> None:
    """Refuse a pretrain run configuration that the reference does not
    define, naming what it does define: an MVM target without a file under
    ``targets/`` is refused naming the path looked for. The program computes
    the VTM and MTM losses whatever ``pretrain_tasks`` says; ``mvm`` adds
    each target's losses."""
    for key, known in (("pretrain_tasks", TASKS), ("pretrain_masks", MASKS)):
        if not set(run[key]) <= set(known):
            raise ValueError(f"{key} {list(run[key])}: the reference defines {list(known)}")
    targets.ordered(run["mvm_target"])


def step_generators(seed: int, step: int, device) -> tuple[torch.Generator, torch.Generator]:
    """The (dropout, mask) generators of step ``step`` of a run seeded ``seed``."""
    words = np.random.SeedSequence([seed, step]).generate_state(4, dtype=np.uint32)
    return tuple(torch.Generator(device).manual_seed(int(words[2 * i]) << 32 | int(words[2 * i + 1]))
                 for i in range(2))


# -------------------------------------------------------------------- masking

def _randint(gen, low, high, shape, device):
    u = torch.rand(shape, generator=gen, device=device)
    return low + (u * (high - low)).long()


def _tube_cover(gen, b, t, h, w, device):
    shape = (b, t)
    bt = (_randint(gen, 1, max(t, 2), shape, device) if t > 1
          else torch.ones(shape, dtype=torch.int64, device=device))
    bh = _randint(gen, 1, max(h * 2 // 3, 2), shape, device)
    bw = _randint(gen, 1, max(w * 2 // 3, 2), shape, device)
    t1 = _randint(gen, 0, t - bt + 1, shape, device)
    h1 = _randint(gen, 0, h - bh + 1, shape, device)
    w1 = _randint(gen, 0, w - bw + 1, shape, device)
    t1, bt, h1, bh, w1, bw = (v[..., None, None, None] for v in (t1, bt, h1, bh, w1, bw))
    it = torch.arange(t, device=device).view(t, 1, 1)
    ih = torch.arange(h, device=device).view(1, h, 1)
    iw = torch.arange(w, device=device).view(1, 1, w)
    inside = ((it >= t1) & (it < t1 + bt) & (ih >= h1) & (ih < h1 + bh)
              & (iw >= w1) & (iw < w1 + bw))
    return inside.any(dim=1).float()


def mask_batch(gen, img, txt, mask_types, p_mask, patch):
    """rm / bm masking: each sample's cover type, its patch cover, the text
    positions to mask (shared by rm and bm). Returns the masked clip, the
    masked text, the MTM answers, the patch cover (B, T, h, w) and the
    pixel cover (B, T, H, W, 1)."""
    b, t, hh, ww = img.shape[:4]
    h, w = hh // patch, ww // patch
    dev = txt.device
    spc = txt == MASK_TOKEN
    for tok in SPECIAL_TOKENS:
        spc = spc | (txt == tok)
    choice = _randint(gen, 0, len(mask_types), (b,), dev)
    sel = (torch.rand(txt.shape, generator=gen, device=dev) < p_mask) & ~spc
    covs = []
    for mt in mask_types:
        if mt == "rm":
            covs.append((torch.rand((b, t, h, w), generator=gen, device=dev) < p_mask).float())
        elif mt == "bm":
            covs.append(_tube_cover(gen, b, t, h, w, dev))
        else:
            raise ValueError(f"mask type {mt!r} is not in the reference")
    cov = torch.stack(covs)[choice, torch.arange(b, device=dev)]
    ans = torch.where(sel, txt, -1)
    new_txt = torch.where(sel, MASK_TOKEN, txt).to(txt.dtype)
    pix = cov.repeat_interleave(patch, 2).repeat_interleave(patch, 3)[..., None]
    return img * (1.0 - pix), new_txt, ans, cov, pix


def draw_negatives(gen, b, k):
    scores = torch.rand((b, b), generator=gen, device=gen.device)
    scores = scores - 2.0 * torch.eye(b, device=gen.device)
    return scores.topk(k, dim=1).indices


# --------------------------------------------------------------------- losses

def cross_entropy_ignore(logits, labels):
    v = logits.shape[-1]
    lf, lab = logits.reshape(-1, v), labels.reshape(-1).long()
    valid = lab != -1
    ls = torch.logsumexp(lf, dim=-1) - lf.gather(1, torch.where(valid, lab, 0)[:, None])[:, 0]
    return torch.where(valid, ls, 0.0).sum() / valid.sum().clamp(min=1)


def masked_l1(pred, target, mask, channel_div=1.0):
    m = mask.float()
    return ((pred - target).abs() * m).sum() / (m.sum() + 1e-5) / channel_div


@dataclass
class MVMInputs:
    """What a target's ``losses`` reads: the normalized unmasked clip (B, T,
    H, W, 3), the fused patch tokens (B, T, h, w, D), the patch cover (B,
    T, h, w) and the pixel cover (B, T, H, W, 1) of the masking, and the
    dropout generator; ``kept`` takes the reference's outputs of the
    target's checked numbers, each with its scale."""
    img: torch.Tensor
    grid: torch.Tensor
    cov: torch.Tensor
    pix: torch.Tensor
    drop_gen: torch.Generator | None
    kept: dict = field(default_factory=dict)


def pretrain_losses(model, batch, drop_gen, mask_gen, train: dict) -> dict:
    """Masking, forward, the VTM and MTM losses and, with the ``mvm`` task,
    each target's losses in the program's order. ``_vtm`` holds the VTM
    scores and scales, ``_kept`` the targets' checked outputs."""
    img = normalize(batch["img"])
    txt, mask = batch["txt"], batch["mask"]
    b, t = img.shape[:2]
    patch = model.cfg["size_patch"]
    h, w = img.shape[2] // patch, img.shape[3] // patch
    m_img, m_txt, ans_mtm, cov, pix = mask_batch(mask_gen, img, txt, train["pretrain_masks"],
                                                 train["p_mask"], patch)
    o = min(b, model.num_options)
    neg_idx = draw_negatives(mask_gen, b, o - 1)
    out = model(m_img, m_txt, mask, neg_idx, drop_gen)
    ls = {"mtm": cross_entropy_ignore(out["out_mtm"], ans_mtm),
          "vtm": cross_entropy_ignore(out["out_vtm"] / train["temp"],
                                      torch.zeros(b, dtype=torch.int64, device=img.device))}
    mvm = None
    if "mvm" in train["pretrain_tasks"]:
        grid = out["out_mvm"].reshape(b, t, 1 + h * w, -1)[:, :, 1:].reshape(b, t, h, w, -1)
        mvm = MVMInputs(img, grid, cov, pix, drop_gen)
        for target in model.targets:
            ls.update(target.losses(model, mvm))
    ls["total"] = sum(ls.values())
    ls["_vtm"] = (out["vtm_scores"], out["vtm_scales"])
    ls["_kept"] = mvm.kept if mvm is not None else {}
    return ls


# ------------------------------------------------------------------ optimizer

class AdamW:
    """AdamW(0.9, 0.98), eps 1e-8 outside the root, decoupled decay added to
    the update; no decay on biases and LayerNorm weights; warmup-linear lr
    from lr(0); gradients clipped to ``max_grad_norm`` by their global norm;
    the teacher frozen."""

    def __init__(self, model, train: dict, max_iter: int):
        norms = {id(m.weight) for m in model.modules() if isinstance(m, LayerNorm)}
        self.params = {n: p for n, p in model.named_parameters() if not model.frozen(n)}
        self.decay = {n: 0.0 if ("bias" in n.rsplit(".", 1)[-1] or id(p) in norms)
                      else train["decay"] for n, p in self.params.items()}
        self.lr, self.max_iter = train["lr"], max_iter
        self.warmup = int(train.get("warmup_ratio", 0.1) * max_iter)
        self.min_lr, self.clip = train.get("min_lr", 1e-8), train["max_grad_norm"]
        self.b1, self.b2 = 0.9, 0.98
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.count = 0

    def rate(self, step: int) -> float:
        step = min(step, self.max_iter)
        if step < self.warmup:
            f = step / max(self.warmup, 1)
        else:
            f = (self.max_iter - step) / max(self.max_iter - self.warmup, 1)
        return max(self.min_lr, self.lr * max(0.0, f))

    @torch.no_grad()
    def step(self) -> dict[str, torch.Tensor]:
        """One update; returns the clipped gradients it applied."""
        g = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in self.params.items()}
        norm = torch.linalg.vector_norm(torch.stack([x.norm() for x in g.values()]))
        factor = 1.0 if norm < self.clip else self.clip / norm
        g = {n: x * factor for n, x in g.items()}
        self.count += 1
        bc1, bc2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        lr = self.rate(self.count - 1)
        for n, p in self.params.items():
            self.mu[n].mul_(self.b1).add_(g[n], alpha=1.0 - self.b1)
            self.nu[n].mul_(self.b2).addcmul_(g[n], g[n], value=1.0 - self.b2)
            upd = (self.mu[n] / bc1) / ((self.nu[n] / bc2).sqrt() + EPS)
            if self.decay[n]:
                upd = upd + self.decay[n] * p
            p.add_(upd, alpha=-lr)
        return g


def train_steps(model, batches, seed: int, train: dict, max_iter: int):
    """``len(batches)`` pretrain steps. Returns each step's losses (floats),
    the per-leaf norms of the first step's clipped gradient, the parameters
    after the last step, the first step's VTM scores (positive rows, then
    negative rows) with their scales, and its targets' checked outputs."""
    opt = AdamW(model, train, max_iter)
    device = next(model.parameters()).device
    losses, first_grad, first_vtm, first_kept = [], None, None, None
    for i, batch in enumerate(batches):
        drop_gen, mask_gen = step_generators(seed, i, device)
        for p in model.parameters():
            p.grad = None
        ls = pretrain_losses(model, batch, drop_gen, mask_gen, train)
        vtm, kept = ls.pop("_vtm"), ls.pop("_kept")
        ls["total"].backward()
        g = opt.step()
        losses.append({k: float(v.detach()) for k, v in ls.items()})
        if i == 0:
            first_grad = {n: float(x.norm()) for n, x in g.items()}
            first_vtm, first_kept = vtm, kept
        del ls, g
    return losses, first_grad, opt.params, first_vtm, first_kept


@torch.no_grad()
def retrieval_scores(model, videos, txt, mask, pairs, chunk: int = 64):
    """Stage 1 for the given videos (V, Clips, T, H, W, 3) uint8 and
    captions (N, X), then stage 2 for ``pairs`` (P, 2) of (caption, video)
    indices into them. Returns the video tokens (V, Lv, D), the P scores,
    and each score's scale: the norm of the terms w_i * relu(h)_i that the
    score head's last product sums, which bounds what rounding can move."""
    fi, mi = [], []
    for v0 in range(0, len(videos), 4):
        f, m = model.encode_video(videos[v0:v0 + 4])
        fi.append(f)
        mi.append(m)
    fi, mi = torch.cat(fi), torch.cat(mi)
    ft = model.enc_txt(txt)
    scores, scales = [], []
    for c0 in range(0, len(pairs), chunk):
        ti, vj = pairs[c0:c0 + chunk, 0], pairs[c0:c0 + chunk, 1]
        s, t = model.score_terms(fi[vj], mi[vj], ft[ti], mask[ti])
        scores.append(s)
        scales.append(t)
    return fi, torch.cat(scores), torch.cat(scales)
