"""Downstream task models (counterpart of ``empirical_mvm_tpu/models/tasks.py``),
each a head over the VIOLET trunk: retrieval (``VioletRetrieval``, all-pairs
scores for the ``nce`` fine-tune step, and the two-stage eval's pieces), the
score-head multiple choice (``VioletQAMC``, with the gumbel video-token
selection), the MLM-head multiple choice (``VioletQAMCGen``,
``VioletQAMCMLMHead``, and ``qamc_mlm_head_accuracy``) and open-ended QA
(``VioletQAOE``, ``VioletQAOEMLMHead``). Captioning, a head over the same
trunk, is ``models/captioning.py``.

Every model is built on ``device`` (the card unless the caller asks for the
CPU) with parameters drawn from ``seed``; load a converted checkpoint with
``load_state_dict`` to replace them. ``forward`` with a ``generator`` runs
the training pass (dropout, drop path and the gumbel noise drawn from it),
without one the deterministic pass. Data parallel
(``parallel.mesh.data_parallel``), retrieval scores this rank's videos
against every rank's captions, and the gumbel noise is drawn for the global
batch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from empirical_mvm_torch.core.config import ModelConfig
from empirical_mvm_torch.models.bert import BertMLMHead, extended_attention_mask
from empirical_mvm_torch.models.common import Linear, init_weights
from empirical_mvm_torch.models.violet import ScoreHead, VioletBase
from empirical_mvm_torch.parallel.mesh import gather_rows, global_rows, local_rows


def first_text(feat_img: torch.Tensor) -> int:
    """Index of the first text token in the fused sequence, where the heads
    read (ref: main_retrieval.py:81): the video tokens' count, t * (1 + h *
    w), with t = 1 under mean temporal fusion. The JAX package's
    ``_cls_pos`` counts the clip's frames T there, so under mean fusion it
    reads a text token past the first, or past the sequence's end, which
    JAX clamps to its last token (ROADMAP Queue 3); the port does not copy
    that."""
    return feat_img.shape[1]


class _Task(VioletBase):
    """The trunk and its heads, built on ``device`` from ``seed``: ``heads``
    (model dims -> modules) runs under the device context, then every
    parameter is drawn."""

    def __init__(self, config: ModelConfig, dtype, device, seed: int, heads):
        device = torch.device(device)
        with device:
            super().__init__(config, dtype)
            heads(config.hidden_size)
        init_weights(self, torch.Generator(device).manual_seed(seed))


class VioletRetrieval(_Task):
    """(ref: main_retrieval.py:57-85, eval_retrieval.py:96-115)"""

    def __init__(self, config: ModelConfig, dtype=torch.float32,
                 device="cuda", seed: int = 0):
        def heads(d):
            self.fc = ScoreHead(d, dtype=dtype)
        super().__init__(config, dtype, device, seed, heads)

    def forward(self, img, txt, mask, generator=None):
        """All-pairs scores (B, B): row i is video i against every caption,
        the pairs row-major (ref: main_retrieval.py:71-76). Data parallel,
        this rank's videos against the global batch's captions (B / W, B)."""
        b = img.shape[0]
        fi, mi, ft, mt = self.go_feat(img, txt, mask, generator)
        ft, mt = gather_rows(ft), gather_rows(mt)
        n = ft.shape[0]
        out = self.go_cross(fi.repeat_interleave(n, 0), mi.repeat_interleave(n, 0),
                            torch.cat([ft] * b), torch.cat([mt] * b), generator)
        return self.fc(out[:, first_text(fi)], generator).reshape(b, n)

    def encode(self, img, txt, mask):
        """Stage-1 features of the two-stage eval. ``img`` is (B, Clips, T, H,
        W, 3), whose clips are mean-pooled with the mask of the first clip,
        or (B, T, H, W, 3) (ref: eval_retrieval.py:100-110)."""
        if img.ndim == 6:
            b, clips = img.shape[:2]
            fi, mi = self.enc_img(img.reshape(-1, *img.shape[2:]))
            fi = fi.reshape(b, clips, -1, fi.shape[-1]).mean(dim=1)
            mi = mi.reshape(b, clips, -1)[:, 0]
        else:
            fi, mi = self.enc_img(img)
        return fi, mi, self.enc_txt(txt, mask_txt=mask), mask

    def score_pairs(self, feat_img, mask_img, feat_txt, mask_txt):
        """Stage-2 cross scores of prepared (text, video) rows, read at the
        first text token (ref: eval_retrieval.py:112-115)."""
        out = self.go_cross(feat_img, mask_img, feat_txt, mask_txt)
        return self.fc(out[:, feat_img.shape[1]])[..., 0]


def draw_gumbel(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(u)) of u uniform on [tiny, 1), as
    ``jax.random.gumbel`` makes them; ``shape[0]`` is this rank's rows of
    the global batch."""
    u = torch.rand((global_rows(shape[0]), *shape[1:]), generator=generator,
                   device=generator.device)
    u = local_rows(u)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


class VioletQAMC(_Task):
    """Score-head multiple choice (ref: main_qamc.py:50-98; JAX
    ``VioletQAMC``): each (question, option) row is cross-encoded with its
    video and scored at the first text token. ``txt`` and ``mask`` are (B,
    O, X); the logits are (B, O).

    ``num_video_tokens > 0`` adds the gumbel video-token selection (ref:
    main_qamc.py:55-83): bias-free ``vid_key`` / ``vid_query`` projections
    of the video tokens score them in ``num_video_tokens`` heads, and a hard
    gumbel-softmax per head keeps one token; the tokens no head keeps are
    masked out of the fusion.
    """

    gumbel_tau = 1.0        # the JAX field's value; no caller sets another

    def __init__(self, config: ModelConfig, dtype=torch.float32, device="cuda",
                 seed: int = 0, num_video_tokens: int = -1):
        self.num_video_tokens = num_video_tokens

        def heads(d):
            self.fc = ScoreHead(d, dtype=dtype)
            if num_video_tokens > 0:
                self.vid_key = Linear(d, d, bias=False, compute_dtype=dtype)
                self.vid_query = Linear(d, d, bias=False, compute_dtype=dtype)
        super().__init__(config, dtype, device, seed, heads)

    def select_vid_token(self, feat_img, mask_img, generator=None, noise=None):
        """The video-token mask (B, L) that the gumbel selection keeps (ref:
        main_qamc.py:68-83, JAX ``select_vid_token``). The fp32 scores q.k /
        sqrt(D) plus the mask's extended bias, softmaxed over keys and summed
        over queries, give each head a distribution over the L tokens; the
        hard gumbel-softmax (straight-through) picks one token a head.
        ``noise`` (B, heads, L) replaces the Gumbel draws; without it they
        come from ``generator``, and without a generator they are 0 (the
        eval)."""
        b, l, d = feat_img.shape
        nh = self.num_video_tokens
        k = self.vid_key(feat_img).reshape(b, l, nh, d // nh).transpose(1, 2).float()
        q = self.vid_query(feat_img).reshape(b, l, nh, d // nh).transpose(1, 2).float()
        scores = q @ k.transpose(-1, -2) / math.sqrt(d) + extended_attention_mask(mask_img)
        probs = torch.softmax(scores, dim=-1).sum(dim=-2)               # (B, nH, L)
        if noise is None:
            noise = (draw_gumbel(probs.shape, generator) if generator is not None
                     else torch.zeros_like(probs))
        y = torch.softmax((probs.clamp(min=1e-20).log() + noise) / self.gumbel_tau, dim=-1)
        hard = torch.nn.functional.one_hot(y.argmax(dim=-1), l).to(y.dtype)
        picked = (hard + y - y.detach()).sum(dim=1)                     # (B, L)
        return (mask_img * (picked > 0)).to(mask_img.dtype)

    def forward(self, img, txt, mask, generator=None, gumbel_noise=None):
        """img (B, T, H, W, 3); txt, mask (B, O, X). ``gumbel_noise`` is the
        selection's ``noise``."""
        b, o, x = txt.shape
        fi, mi, ft, mt = self.go_feat(img, txt.reshape(b * o, x), mask.reshape(b * o, x),
                                      generator)
        if self.num_video_tokens > 0:
            mi = self.select_vid_token(fi, mi, generator, gumbel_noise)
        out = self.go_cross(fi.repeat_interleave(o, 0), mi.repeat_interleave(o, 0), ft, mt,
                            generator)
        return self.fc(out[:, first_text(fi)], generator).reshape(b, o)


class VioletQAMCGen(_Task):
    """Generative multiple choice, the reference's recommended TGIF path
    (ref: main_qamc_tsv_mlm_gen_ans_idx.py:83-100): the options stand in one
    prompt per question, txt (B, X); returns the MLM logits (B, X, V) of the
    text positions, which ``qamc_gen_accuracy`` reads over the digit tokens
    at [MASK]."""

    def __init__(self, config: ModelConfig, dtype=torch.float32, device="cuda",
                 seed: int = 0):
        def heads(d):
            self.fc_mtm = BertMLMHead(config.fusion, dtype)
        super().__init__(config, dtype, device, seed, heads)

    def forward(self, img, txt, mask, generator=None):
        fi, mi, ft, mt = self.go_feat(img, txt, mask, generator)
        out = self.go_cross(fi, mi, ft, mt, generator)
        return self.fc_mtm(out[:, first_text(fi):])


class VioletQAMCMLMHead(_Task):
    """MLM-head multiple choice (ref: main_qamc_tsv_mlm_head.py:61-95): each
    (question, option) row ends in [MASK], where the model predicts "true"
    or "false". txt, mask (B, O, X); returns the MLM logits (B, O, X, V)."""

    def __init__(self, config: ModelConfig, dtype=torch.float32, device="cuda",
                 seed: int = 0):
        def heads(d):
            self.fc_mtm = BertMLMHead(config.fusion, dtype)
        super().__init__(config, dtype, device, seed, heads)

    def forward(self, img, txt, mask, generator=None):
        b, o, x = txt.shape
        fi, mi, ft, mt = self.go_feat(img, txt.reshape(b * o, x), mask.reshape(b * o, x),
                                      generator)
        out = self.go_cross(fi.repeat_interleave(o, 0), mi.repeat_interleave(o, 0), ft, mt,
                            generator)
        return self.fc_mtm(out[:, first_text(fi):]).reshape(b, o, x, -1)


def qamc_mlm_head_accuracy(logits, mask_ans, true_token_id: int,
                           false_token_id: int) -> list[float]:
    """Per question, 1 where the option of the largest p_true / (p_true +
    p_false + 1e-9) is the true one (ref: main_qamc_tsv_mlm_head.py:112-122).
    As in the JAX package, p_true and p_false are the raw logits of the
    "true" and "false" tokens at the option's first answer slot, not
    probabilities; an option without a slot scores -inf, a question
    without a true option counts 0. logits (B, O, X, V), mask_ans (B, O, X)."""
    logits = np.asarray(logits)
    mask_ans = np.asarray(mask_ans)
    accs = []
    for i in range(logits.shape[0]):
        scores, truth = [], []
        for j in range(logits.shape[1]):
            pos = np.where(mask_ans[i, j] != -1)[0]
            if len(pos) == 0:
                scores.append(-np.inf)
                truth.append(False)
                continue
            p_true = logits[i, j, pos[0], true_token_id]
            p_false = logits[i, j, pos[0], false_token_id]
            scores.append(p_true / (p_true + p_false + 1e-9))
            truth.append(int(mask_ans[i, j, pos[0]]) == true_token_id)
        ans = int(np.argmax(truth)) if any(truth) else -1
        accs.append(float(int(np.argmax(scores)) == ans))
    return accs


class VioletQAOE(_Task):
    """Open-ended QA over an answer vocabulary (ref: main_qaoe.py:41-57): a
    ``config.size_vocab``-way score head at the first text token; txt (B,
    X), logits (B, size_vocab)."""

    def __init__(self, config: ModelConfig, dtype=torch.float32, device="cuda",
                 seed: int = 0):
        def heads(d):
            self.fc = ScoreHead(d, config.size_vocab, dtype=dtype)
        super().__init__(config, dtype, device, seed, heads)

    def forward(self, img, txt, mask, generator=None):
        fi, mi, ft, mt = self.go_feat(img, txt, mask, generator)
        out = self.go_cross(fi, mi, ft, mt, generator)
        return self.fc(out[:, first_text(fi)], generator)


class VioletQAOEMLMHead(_Task):
    """Open-ended QA and fill-in-the-blank through the MLM head (ref:
    main_qaoe_lsmdc_fib.py:55-84, main_qaoe_tsv_mlm_head.py): the answer is
    read at [MASK]. txt (B, X); returns the MLM logits (B, X, V) of the text
    positions, after the task-token or prompt prefix of
    :meth:`VioletBase.prepend_pretxt`, so ``mask_ans`` aligns with ``txt``.

    ``prompt_tokens``: a prompt fixed for the run, [CLS] ... [SEP] (the
    JAX ``prompt_tokens``; its mask, the JAX ``prompt_mask_static``, is
    where the tokens are not [PAD]), used when ``enable_prompt`` is set and
    no ``prompt`` is passed."""

    def __init__(self, config: ModelConfig, dtype=torch.float32, device="cuda",
                 seed: int = 0, prompt_tokens=()):
        tokens = torch.tensor(prompt_tokens, dtype=torch.int32, device=torch.device(device))
        self.prompt_static = (tokens, (tokens != 0).to(torch.int32)) if prompt_tokens else None

        def heads(d):
            self.fc_mtm = BertMLMHead(config.fusion, dtype)
        super().__init__(config, dtype, device, seed, heads)

    def forward(self, img, txt, mask, prompt=None, generator=None):
        if prompt is None and self.config.enable_prompt:
            prompt = self.prompt_static
        fi, mi, ft, mt = self.go_feat(img, txt, mask, generator)
        mt, ft, pre = self.prepend_pretxt(mt, ft, prompt, generator)
        out = self.go_cross(fi, mi, ft, mt, generator)
        return self.fc_mtm(out[:, first_text(fi) + pre:])
