#!/usr/bin/env python3
"""Drive the PyTorch port (empirical_mvm_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which records its failures; the script exits non-zero,
before the final line, if any phase failed:

1. Device: a CUDA card must be present; prints its name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them.
2. Build: compiles csrc/*.cu with nvcc for sm_90a into build/ and prints the
   build time and ptxas' register and shared-memory report.
3. Kernels against plain versions, at every shape the main paths give them:
   fp32 with TF32 off (limits ``FP32_*`` below), and bf16 against the plain
   version on the same bf16 inputs, run in fp32 and run in bf16 (limits
   ``BF16_*``). The backward kernels (LayerNorm, direct window attention,
   lane self-attention) and the lane forward with dropout (same Philox seed
   as its plain version, compared element by element) are checked the same
   way. Each kernel, its plain version and one PyTorch library call
   computing the same function (SDPA with bias + mask as ``attn_mask``, and
   ``dropout_p`` for the dropout rows, its backward through autograd;
   ``F.layer_norm`` and its backward) are timed with CUDA events in the
   main path's dtype. The forward kernels are checked and timed at the
   eval's shapes and at the train step's. Prints one ``kernel_shapes`` line with the per-shape
   numbers and, at the end, one ``kernels`` JSON line.
4. The retrieval eval at full width: VioletRetrieval at
   configs/msrvtt-retrieval.json (Swin-base, 5 frames of 224^2, 25 text
   tokens, 12-layer BERT-base fusion), seeded random weights, bf16, runs
   retrieval_two_stage_eval on 16 captions x 16 videos of 2 clips (seeded
   uint8 clips). Launch counts are zeroed just before the first timed eval
   and read just after it; every eval kernel must have launched. The stage
   throughputs are the median and range over ``EVAL_REPEATS`` evals after
   one warm-up eval.
5. Whole retrieval model: encode + score_pairs on 2 videos x 1 clip, 4
   pairs, on the card in fp32 (kernels) against the CPU in fp32 (plain
   versions), atol and rtol 1e-3; the bf16 run's difference is printed.
6. The pretrain train step at full width: VioletPretrain at
   configs/pretrain.json (Video-Swin-base student, 4 frames of 224^2, 32
   text tokens, 12-layer BERT-base fusion, MTM + VTM + MVM-pixel, bm/rm
   masking, 4-group AdamW), ``size_batch`` = 20 seeded uint8 clips and
   padded captions, seeded random weights, bf16 compute. One warm-up step,
   then ``TRAIN_STEPS`` timed steps (host clock ending in a synchronise):
   clips/s median and range, peak device memory, every loss of every step.
   Launch counts are zeroed just before the first timed step and read just
   after it: every kernel of the step, backward kernels included, must
   have launched as often as its sites in the model. Every loss must be
   finite and every parameter that gets a gradient must have changed.
7. Whole train step: one step of a depth-cut copy (swin depths (2,2,2,2),
   2 fusion layers, full widths) on the card in fp32 against the same step
   on the CPU in fp32 (plain versions), with the same injected masks and
   negatives and every dropout and drop-path rate at 0; losses and every
   parameter's gradient held to ``WHOLE_STEP_TOL``, the differences printed.
8. The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from empirical_mvm_torch.core.config import SwinConfig, load_run_config
from empirical_mvm_torch.data.masking import draw_masks
from empirical_mvm_torch.models.pretrain import VioletPretrain, draw_negatives
from empirical_mvm_torch.models.tasks import VioletRetrieval
from empirical_mvm_torch.models.video_swin import _shift_attn_mask, get_window_size
from empirical_mvm_torch.ops import _build
from empirical_mvm_torch.ops import layernorm as ln
from empirical_mvm_torch.ops import window_attention as wa
from empirical_mvm_torch.train.evaluators import retrieval_two_stage_eval
from empirical_mvm_torch.train.optimizer import AdamW
from empirical_mvm_torch.train.train_step import create_train_state, make_pretrain_train_step

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs" / "msrvtt-retrieval.json"
PRETRAIN_CONFIG = REPO / "configs" / "pretrain.json"

# Main-path sizes of phase 4: one stage-1 encode batch of ITEMS captions with
# CLIPS clips each, and stage-2 chunks of CHUNK (text, video) pairs.
ITEMS, CLIPS, CHUNK = 16, 2, 64
EVAL_REPEATS = 7

# The train step: TRAIN_STEPS timed steps after one warm-up, the schedule of
# a run of TRAIN_MAX_ITER steps (warmup over its first 10%). The train-path
# kernel shapes of phase 3 follow from configs/pretrain.json at size_batch 20:
# swin (20, 4, 56>>s, 56>>s, 3*128<<s), N = 4*7*7 = 196; fusion rows 20 + 60
# negatives of L = 4 * (1 + 49) + 32 = 232.
TRAIN_STEPS, TRAIN_MAX_ITER, TRAIN_SEED = 10, 1000, 0
TRAIN_B, TRAIN_T, TRAIN_L, P_ATTN = 20, 4, 232, 0.1
# LayerNorm sites (label, rows, eps, dtype). Eval: fusion layers (CHUNK x
# 275 rows), EncVideo.norm (32 clips x 250), text embeddings (ITEMS x 25,
# fp32: the embedding sum stays fp32). Train step: fusion (80 x 232),
# EncVideo (20 x 4 x 50), text embeddings and MLM head (20 x 32).
EVAL_LN = (("fusion", CHUNK * 275, 1e-12, torch.bfloat16),
           ("enc_video", ITEMS * CLIPS * 250, 1e-5, torch.bfloat16),
           ("embeddings", ITEMS * 25, 1e-12, torch.float32))
TRAIN_LN = (("fusion", 80 * 232, 1e-12, torch.bfloat16),
            ("enc_video", 20 * 4 * 50, 1e-5, torch.bfloat16),
            ("embeddings", 20 * 32, 1e-12, torch.float32),
            ("mlm_head", 20 * 32, 1e-12, torch.bfloat16))
# launches of one train step: LayerNorm at 24 fusion sites + EncVideo +
# embeddings + MLM head; a swin attention in each of the 24 blocks; one
# fusion attention in each of the 12 layers
TRAIN_LAUNCHES = {"fused_layer_norm": 27, "fused_layer_norm_bwd": 27,
                  "direct_window_attention": 24, "direct_window_attention_bwd": 24,
                  "lane_self_attention_dropout": 12, "lane_self_attention_bwd": 12}
EVAL_KERNELS = ("fused_layer_norm", "direct_window_attention", "lane_self_attention")

# Limits. A tolerance is dict(atol=..., rtol=..., scale=...): an element may
# differ by atol + rtol * |reference| + scale * max|reference|. Gradients
# have no natural unit, so the backward limits are mostly in ``scale``.
#
# fp32 with TF32 off, kernel against the plain version: the same arithmetic
# in another summation order. Forward attention 1e-4 and LayerNorm 1e-5 (as
# in the first slice); the backward outputs sum longer chains (dbias over up
# to 1280 windows, dgamma/dbeta over up to 18,560 rows), 1e-4 of their scale,
# and the LayerNorm dx 1e-5 of its scale.
FP32_LIMITS = {
    "attention": {"out": dict(atol=1e-4)},
    "layer_norm": {"out": dict(atol=1e-5)},
    "attention_bwd": {"dx3": dict(scale=1e-4), "dbias": dict(scale=1e-4)},
    "layer_norm_bwd": {"dx": dict(scale=1e-5), "dgamma": dict(scale=1e-4),
                       "dbeta": dict(scale=1e-4)},
}
# bf16. Against the plain version in fp32 on the same bf16 inputs (first
# slice): attention within about 3.5x its largest reading (1.4e-3, see
# PERF.md), and LayerNorm within half a bf16 step of its output, the one
# rounding it adds. Against the plain version run in bf16, which repeats the
# kernels' roundings (q * scale and the probabilities rounded to bf16): one
# bf16 step of the output, and for attention at most BF16_MISMATCH of the
# elements may differ at all (a dropped inner rounding shows there first;
# LayerNorm rounds only its output, which the one-step limit covers).
BF16_VS_FP32 = {"attention": dict(atol=5e-3, rtol=0.0),
                "layer_norm": dict(atol=1e-5, rtol=2.0 ** -8)}
BF16_SAME_ROUNDING = dict(atol=1e-5, rtol=2.0 ** -7)
BF16_MISMATCH = 1e-3
# bf16 backward, per output.
# * attention dx3 against plain fp32: the kernel rounds p and ds to bf16
#   before their products, as the JAX kernels do, and the fp32 plain version
#   does not; ds sums to zero along each row, so dq and dk are cancelling
#   sums whose rounding noise is a few bf16 steps of the terms: 2e-2 of the
#   output's scale. Against plain bf16 (the same roundings): one bf16 step
#   of the element plus 1e-3 of the scale for an inner rounding of ds that
#   falls the other way after a different fp32 summation order, and at most
#   BF16_BWD_MISMATCH of the elements may differ at all: 33x the largest
#   share read on the H100 (3.05e-5, PERF.md). A dropped rounding of ds or p
#   moves far more elements.
# * attention dbias is fp32 from fp32 ds, but ds comes from scores of
#   q * scale rounded to bf16 (the scale too), which plain fp32 does not
#   round: 2e-2 of its scale, as dx3. Against plain bf16 (the same
#   roundings) only the summation order differs: 1e-4 of its scale.
# * LayerNorm dx rounds once, at its output: half a bf16 step against plain
#   fp32, one step against plain bf16, plus 1e-5 of the scale where the
#   subtraction cancels; dgamma and dbeta are fp32 sums: 1e-4 of the scale.
BF16_BWD_MISMATCH = 1e-3
BF16_LIMITS = {
    "attention": {"out": (BF16_VS_FP32["attention"], BF16_SAME_ROUNDING, BF16_MISMATCH)},
    "layer_norm": {"out": (BF16_VS_FP32["layer_norm"], BF16_SAME_ROUNDING, None)},
    "attention_bwd": {"dx3": (dict(scale=2e-2), dict(rtol=2.0 ** -7, scale=1e-3),
                              BF16_BWD_MISMATCH),
                      "dbias": (dict(scale=2e-2), dict(scale=1e-4), None)},
    "layer_norm_bwd": {"dx": (dict(rtol=2.0 ** -8, scale=1e-5),
                              dict(rtol=2.0 ** -7, scale=1e-5), None),
                       "dgamma": (dict(scale=1e-4), dict(scale=1e-4), None),
                       "dbeta": (dict(scale=1e-4), dict(scale=1e-4), None)},
}
OUTPUTS = {kind: tuple(lim) for kind, lim in FP32_LIMITS.items()}
# dropout keep fraction: 1 - p within 5 binomial standard deviations
KEEP_SIGMAS = 5.0
# the whole train step, card fp32 against CPU fp32: losses at rtol 1e-4;
# each gradient within 2e-3 of its own largest value plus 1e-6 of the
# largest gradient anywhere (summation orders through 8 swin blocks, 2
# fusion layers and the heads; the floor covers gradients that are zero in
# exact arithmetic, such as the key biases under the shift-invariant softmax)
WHOLE_STEP_TOL = dict(loss_rtol=1e-4, grad_scale=2e-3, grad_global=1e-6)

# H100 SXM peaks (NVIDIA data sheet; at the full 700 W power limit)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16_tensor": 989e12, "fp32": 67e12}

KERNELS = {
    "direct_window_attention": dict(
        source="empirical_mvm_torch/csrc/window_attention.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:1306"),
    "lane_self_attention": dict(
        source="empirical_mvm_torch/csrc/self_attention.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:1089"),
    "fused_layer_norm": dict(
        source="empirical_mvm_torch/csrc/layer_norm.cu",
        replaces="empirical_mvm_tpu/ops/layernorm.py:55"),
    "fused_layer_norm_bwd": dict(
        source="empirical_mvm_torch/csrc/layer_norm.cu",
        replaces="empirical_mvm_tpu/ops/layernorm.py:66"),
    "direct_window_attention_bwd": dict(
        source="empirical_mvm_torch/csrc/window_attention.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:1443"),
    "lane_self_attention_dropout": dict(
        source="empirical_mvm_torch/csrc/self_attention.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:1089"),
    "lane_self_attention_bwd": dict(
        source="empirical_mvm_torch/csrc/self_attention.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:1129"),
}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, window_ms: float = 20.0) -> float:
    """Mean device time of fn() over back-to-back calls filling about
    ``window_ms`` (5 to 500 calls), after one timed warm-up call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def run(iters):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    iters = min(500, max(5, int(window_ms / max(run(1), 1e-3))))
    return run(iters)


# ---------------------------------------------------------------------------
# phase 3: one record per (kernel, main-path shape)
# ---------------------------------------------------------------------------

def _excess(diff, ref, atol=0.0, rtol=0.0, scale=0.0):
    """Largest amount by which |diff| exceeds atol + rtol*|ref| + scale*max|ref|."""
    bound = atol + scale * ref.abs().max().item()
    return (diff - bound - rtol * ref.abs()).max().item()


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def bf16_check(kernel, plain, act, kind):
    """Run ``kernel`` on ``act`` rounded to bf16 and hold each output against
    ``plain`` on the same bf16 inputs, run in fp32 and run in bf16, with the
    limits of ``BF16_LIMITS[kind]``. Returns the readings (for a kind with
    one output, ``max_abs_err_bf16``, ``max_abs_err_bf16_same_rounding`` and
    ``mismatch_bf16``; otherwise the same keys per output, ``[name]``
    appended) and the list of limits exceeded, empty when the kernel
    passes."""
    a16 = act.to(torch.bfloat16)
    outs = _tuple(kernel(a16))
    refs32, refs16 = _tuple(plain(a16.float())), _tuple(plain(a16))
    readings, failures = {}, []
    single = len(outs) == 1
    for name, out, r32, r16 in zip(OUTPUTS[kind], outs, refs32, refs16):
        out, r16 = out.float(), r16.float()
        d32, d16 = (out - r32).abs(), (out - r16).abs()
        tag = "" if single else f"[{name}]"
        readings.update({f"max_abs_err_bf16{tag}": d32.max().item(),
                         f"max_abs_err_bf16_same_rounding{tag}": d16.max().item(),
                         f"mismatch_bf16{tag}": (d16 > 0).float().mean().item()})
        vs32, same, mismatch = BF16_LIMITS[kind][name]
        over = _excess(d32, r32, **vs32)
        if over > 0:
            failures.append(f"{name} bf16 vs plain fp32 exceeds {vs32} by {over:.3g}")
        over = _excess(d16, r16, **same)
        if over > 0:
            failures.append(f"{name} bf16 vs plain bf16 exceeds {same} by {over:.3g}")
        if mismatch is not None and readings[f"mismatch_bf16{tag}"] > mismatch:
            failures.append(f"{name} bf16: {readings[f'mismatch_bf16{tag}']:.3g} of the "
                            f"elements differ from plain bf16, above {mismatch}")
        del d32, d16
    return readings, failures


def measure(name, label, act, kernel, plain, library, work_dtype, kind, ops, ops_peak,
            nbytes):
    """Check ``kernel(act)`` against ``plain(act)`` in fp32 and bf16, then
    time kernel, plain and library in ``work_dtype``. ``library(a)`` returns
    a zero-argument callable, its inputs prepared outside the timed call.
    The record's ``failures`` lists the limits exceeded."""
    outs, refs = _tuple(kernel(act)), _tuple(plain(act))
    failures, errs = [], {}
    for out_name, out, ref in zip(OUTPUTS[kind], outs, refs):
        errs[out_name] = (out - ref).abs().max().item()
        over = _excess((out - ref).abs(), ref, **FP32_LIMITS[kind][out_name])
        if over > 0:
            failures.append(f"{out_name} fp32 max err {errs[out_name]} exceeds "
                            f"{FP32_LIMITS[kind][out_name]} by {over:.3g}")
    del outs, refs
    readings, bf16_failures = bf16_check(kernel, plain, act, kind)
    failures += bf16_failures
    a = act.to(work_dtype)
    lib_call = library(a)
    rec = dict(kernel=name, shape=label, dtype=str(work_dtype).replace("torch.", ""),
               max_abs_err=max(errs.values()),
               **({} if len(errs) == 1 else {"max_abs_err_fp32": errs}), **readings,
               ms=time_ms(lambda: kernel(a)), plain_ms=time_ms(lambda: plain(a)),
               library_ms=time_ms(lib_call))
    t_ops = ops / PEAK_OPS_S[ops_peak] * 1e3
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    rec.update(bound_ms=max(t_ops, t_bytes),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               failures=[f"{name} [{label}] {f}" for f in failures])
    del lib_call
    torch.cuda.empty_cache()
    print(json.dumps(rec), flush=True)
    return rec


def _grad_call(out, inputs, grad):
    """Backward of an autograd graph already built: the library yardstick
    of a backward kernel."""
    return lambda: torch.autograd.grad(out, inputs, grad, retain_graph=True)


def direct_cases(dev, gen, b, t, path):
    """Every swin stage of the student, ``b`` clips of ``t`` frames at
    224^2: the eval at msrvtt-retrieval (32 clips, T = 5: the window clamps
    to (5, 7, 7), N = 245) and the train step (20 clips, T = 4: N = 196);
    hd = 32."""
    recs = []
    for stage in range(4):
        hw, c, nh = 56 >> stage, 128 << stage, 4 << stage
        win, shift = get_window_size((t, hw, hw), (8, 7, 7), (4, 3, 3))
        n = win[0] * win[1] * win[2]
        hp = -(-hw // win[1]) * win[1]
        x3 = torch.randn(b, t, hp, hp, 3 * c, device=dev, generator=gen) * 0.5
        bias = torch.randn(nh, n, n, device=dev, generator=gen) * 0.02
        masks = [None]
        if any(shift):
            masks.append(torch.from_numpy(_shift_attn_mask((t, hp, hp), win, shift)).to(dev))
        scale = (c // nh) ** -0.5
        for mask in masks:
            nw = (hp // win[1]) * (hp // win[2])

            def kernel(a, mask=mask):
                return wa.direct_window_attention(a, bias, mask, win, nh, scale)

            def plain(a, mask=mask):
                return wa.direct_window_attention_plain(a, bias, mask, win, nh, scale)

            def library(a, mask=mask):
                hd = c // nh
                qkv = wa.window_partition(a, win).reshape(b, nw, n, 3, nh, hd)
                q, k, v = qkv.permute(3, 0, 1, 4, 2, 5).contiguous().unbind(0)
                m = bias[None] if mask is None else bias[None] + mask[:, None]
                m = m.to(a.dtype)
                return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                                              scale=scale)

            label = f"{path} stage{stage} x3=({b},{t},{hp},{hp},{3 * c}) nH={nh} " + (
                "shifted" if mask is not None else "unshifted")
            ops = 4 * b * nw * nh * n * n * (c // nh)
            nbytes = x3.numel() * 2 + b * t * hp * hp * c * 2 + bias.numel() * 4 + (
                0 if mask is None else mask.numel() * 4)
            recs.append(measure("direct_window_attention", label, x3, kernel, plain,
                                library, torch.bfloat16, "attention", ops, "bf16_tensor",
                                nbytes))
    return recs


def lane_case(dev, gen):
    """Fusion attention of stage 2: CHUNK pairs of 275 tokens (5 x 50 video
    + 25 text), BERT-base heads; padding mask on the text tokens."""
    p, l, d, nh = CHUNK, 275, 768, 12
    x3 = torch.randn(p, l, 3 * d, device=dev, generator=gen) * 0.5
    keep = torch.ones(p, l, device=dev)
    lens = torch.randint(3, 26, (p,), device=dev, generator=gen)
    keep[:, 250:] = (torch.arange(25, device=dev)[None] < lens[:, None]).float()
    bias = (1.0 - keep) * torch.finfo(torch.float32).min
    mask = bias[:, None, :].expand(p, l, l)       # the view BertEncoder passes
    scale = (d // nh) ** -0.5

    def kernel(a):
        return wa.lane_self_attention(a, mask, nh, scale)

    def plain(a):
        return wa.lane_self_attention_plain(a, mask, nh, scale)

    def library(a):
        q, k, v = a.reshape(p, l, 3, nh, d // nh).permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        m = bias[:, None, None, :].to(a.dtype)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=scale)

    ops = 4 * p * nh * l * l * (d // nh)
    nbytes = x3.numel() * 2 + p * l * d * 2 + p * l * 4
    rec = measure("lane_self_attention", f"eval x3=({p},{l},{3 * d}) nH={nh}", x3, kernel,
                  plain, library, torch.bfloat16, "attention", ops, "bf16_tensor", nbytes)
    return [rec]


def ln_cases(dev, gen, sites, path):
    """The LayerNorm sites of a path: ``EVAL_LN`` or ``TRAIN_LN``."""
    c = 768
    recs = []
    for label, rows, eps, work in sites:
        x = torch.randn(rows, c, device=dev, generator=gen) * 2.0 + 0.5
        g = 1.0 + 0.1 * torch.randn(c, device=dev, generator=gen)
        bt = 0.1 * torch.randn(c, device=dev, generator=gen)

        def kernel(a, g=g, bt=bt, eps=eps):
            return ln.fused_layer_norm(a, g, bt, eps)

        def plain(a, g=g, bt=bt, eps=eps):
            return ln.layer_norm_reference(a, g, bt, eps)

        def library(a, g=g, bt=bt, eps=eps):
            gw, bw = g.to(a.dtype), bt.to(a.dtype)
            return lambda: F.layer_norm(a, (c,), gw, bw, eps)

        item = torch.finfo(work).bits // 8
        recs.append(measure("fused_layer_norm", f"{path} {label} rows={rows} C={c} eps={eps}", x,
                            kernel, plain, library, work, "layer_norm", 8 * rows * c, "fp32",
                            2 * rows * c * item + 2 * c * 4))
    return recs


def _bf16_values(t):
    """t rounded to bf16 and held in fp32: a cotangent both dtypes share."""
    return t.to(torch.bfloat16).float()


def direct_bwd_cases(dev, gen):
    """The direct backward at every swin stage of the train step: B = 20
    clips of T = 4 frames at 224^2, window (4, 7, 7), N = 196, hd = 32."""
    b, t = TRAIN_B, TRAIN_T
    recs = []
    for stage in range(4):
        hw, c, nh = 56 >> stage, 128 << stage, 4 << stage
        win, shift = get_window_size((t, hw, hw), (8, 7, 7), (4, 3, 3))
        n = win[0] * win[1] * win[2]
        hp = -(-hw // win[1]) * win[1]
        nw = (hp // win[1]) * (hp // win[2])
        hd = c // nh
        x3 = torch.randn(b, t, hp, hp, 3 * c, device=dev, generator=gen) * 0.5
        do = _bf16_values(torch.randn(b, t, hp, hp, c, device=dev, generator=gen))
        bias = torch.randn(nh, n, n, device=dev, generator=gen) * 0.02
        masks = [None]
        if any(shift):
            masks.append(torch.from_numpy(_shift_attn_mask((t, hp, hp), win, shift)).to(dev))
        scale = hd ** -0.5
        for mask in masks:
            def kernel(a, mask=mask):
                return wa._direct_bwd(a, bias, mask, do.to(a.dtype), win, nh, scale)

            def plain(a, mask=mask):
                return wa.direct_window_attention_backward_plain(a, bias, mask, do.to(a.dtype),
                                                                 win, nh, scale)

            def library(a, mask=mask):
                qkv = wa.window_partition(a, win).reshape(b, nw, n, 3, nh, hd)
                q, k, v = (u.detach().requires_grad_(True) for u in
                           qkv.permute(3, 0, 1, 4, 2, 5).contiguous().unbind(0))
                m = (bias[None] if mask is None else bias[None] + mask[:, None]).to(a.dtype)
                out = F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=scale)
                dop = wa.window_partition(do.to(a.dtype), win).reshape(b, nw, n, nh, hd)
                return _grad_call(out, (q, k, v), dop.transpose(2, 3).contiguous())

            label = f"stage{stage} x3=({b},{t},{hp},{hp},{3 * c}) nH={nh} " + (
                "shifted" if mask is not None else "unshifted")
            ops = 2.5 * 4 * b * nw * nh * n * n * hd
            nbytes = (2 * x3.numel() + do.numel()) * 2 + 2 * bias.numel() * 4 + (
                0 if mask is None else mask.numel() * 4)
            recs.append(measure("direct_window_attention_bwd", label, x3, kernel, plain,
                                library, torch.bfloat16, "attention_bwd", ops,
                                "bf16_tensor", nbytes))
    return recs


def lane_train_cases(dev, gen):
    """The fusion attention of the train step with dropout, forward and
    backward: 20 positive + 60 negative pairs of L = 232 tokens (4 x 50
    video + 32 text), BERT-base heads, p = 0.1, padding mask on the text."""
    p, l, d, nh = 4 * TRAIN_B, TRAIN_L, 768, 12
    hd = d // nh
    x3 = torch.randn(p, l, 3 * d, device=dev, generator=gen) * 0.5
    do = _bf16_values(torch.randn(p, l, d, device=dev, generator=gen))
    keep = torch.ones(p, l, device=dev)
    lens = torch.randint(6, 33, (p,), device=dev, generator=gen)
    keep[:, 200:] = (torch.arange(32, device=dev)[None] < lens[:, None]).float()
    bias = (1.0 - keep) * torch.finfo(torch.float32).min
    mask = bias[:, None, :].expand(p, l, l)       # the view BertEncoder passes
    scale = hd ** -0.5
    seed = torch.tensor([20261016, 7], dtype=torch.int32, device=dev)
    drop_keep = wa.dropout_keep(seed, (p, nh, l, l), P_ATTN)
    frac = drop_keep.float().mean().item()
    sigma = (P_ATTN * (1 - P_ATTN) / drop_keep.numel()) ** 0.5
    del drop_keep
    label = f"x3=({p},{l},{3 * d}) nH={nh} p_drop={P_ATTN}"

    def fwd_kernel(a):
        return wa._lane_fwd(a, mask, nh, scale, P_ATTN, seed)

    def fwd_plain(a):
        return wa.lane_self_attention_plain(a, mask, nh, scale, P_ATTN, seed)

    def heads(a):
        return (u.detach().requires_grad_(True) for u in
                a.reshape(p, l, 3, nh, hd).permute(2, 0, 3, 1, 4).contiguous().unbind(0))

    def fwd_library(a):
        q, k, v = heads(a)
        m = bias[:, None, None, :].to(a.dtype)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                                      dropout_p=P_ATTN, scale=scale)

    def bwd_kernel(a):
        return wa._lane_bwd(a, mask, do.to(a.dtype), nh, scale, P_ATTN, seed)

    def bwd_plain(a):
        return wa.lane_self_attention_backward_plain(a, mask, do.to(a.dtype), nh, scale,
                                                     P_ATTN, seed)

    def bwd_library(a):
        q, k, v = heads(a)
        m = bias[:, None, None, :].to(a.dtype)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=m, dropout_p=P_ATTN,
                                             scale=scale)
        dop = do.to(a.dtype).reshape(p, l, nh, hd).transpose(1, 2).contiguous()
        return _grad_call(out, (q, k, v), dop)

    ops = 4 * p * nh * l * l * hd
    fwd = measure("lane_self_attention_dropout", label, x3, fwd_kernel, fwd_plain,
                  fwd_library, torch.bfloat16, "attention", ops, "bf16_tensor",
                  x3.numel() * 2 + p * l * d * 2 + p * l * 4)
    fwd["keep_fraction"] = frac
    if abs(frac - (1 - P_ATTN)) > KEEP_SIGMAS * sigma:
        fwd["failures"].append(f"dropout keep fraction {frac} is not {1 - P_ATTN} "
                               f"+- {KEEP_SIGMAS} sigma ({sigma:.3g})")
    print(json.dumps({"dropout_keep_fraction": frac, "expected": 1 - P_ATTN,
                      "sigma": sigma}), flush=True)
    bwd = measure("lane_self_attention_bwd", label, x3, bwd_kernel, bwd_plain,
                  bwd_library, torch.bfloat16, "attention_bwd", 2.5 * ops, "bf16_tensor",
                  (2 * x3.numel() + do.numel()) * 2 + p * l * 4)
    return [fwd, bwd]


def ln_bwd_cases(dev, gen):
    """The LayerNorm backward at the four sites of the train step."""
    c = 768
    recs = []
    for label, rows, eps, work in TRAIN_LN:
        x = torch.randn(rows, c, device=dev, generator=gen) * 2.0 + 0.5
        dy = _bf16_values(torch.randn(rows, c, device=dev, generator=gen))
        g = 1.0 + 0.1 * torch.randn(c, device=dev, generator=gen)

        def kernel(a, g=g, dy=dy, eps=eps):
            return ln._ln_bwd(a, g, dy.to(a.dtype), eps)

        def plain(a, g=g, dy=dy, eps=eps):
            return ln.layer_norm_backward_reference(a, g, dy.to(a.dtype), eps)

        def library(a, g=g, dy=dy, eps=eps):
            xl = a.detach().requires_grad_(True)
            gw = g.to(a.dtype).requires_grad_(True)
            bw = torch.zeros_like(gw, requires_grad=True)
            y = F.layer_norm(xl, (c,), gw, bw, eps)
            return _grad_call(y, (xl, gw, bw), dy.to(a.dtype))

        item = torch.finfo(work).bits // 8
        recs.append(measure("fused_layer_norm_bwd", f"{label} rows={rows} C={c} eps={eps}",
                            x, kernel, plain, library, work, "layer_norm_bwd",
                            16 * rows * c, "fp32", 3 * rows * c * item + 3 * c * 4))
    return recs


# ---------------------------------------------------------------------------
# phase 4: the full-width slice
# ---------------------------------------------------------------------------

class SyntheticRetrievalDataset:
    """``n`` captions over ``n`` videos of ``clips`` seeded uint8 clips, the
    interface of data/datasets.py RetrievalDataset.multi_clip_item."""

    def __init__(self, n, clips, frames, size, size_txt, vocab, seed=0):
        rs = np.random.RandomState(seed)
        self.items, self.gt_txt2vid = [], {}
        for i in range(n):
            txt = np.zeros(size_txt, np.int32)
            length = rs.randint(6, size_txt + 1)
            txt[:length] = rs.randint(1000, vocab, length)
            txt[0], txt[length - 1] = 101, 102            # [CLS] ... [SEP]
            self.items.append({
                "img": rs.randint(0, 256, (clips, frames, size, size, 3)).astype(np.uint8),
                "txt": txt, "mask": (txt > 0).astype(np.int32),
                "vid": f"video{i}", "tid": i})
            self.gt_txt2vid[i] = f"video{i}"

    def __len__(self):
        return len(self.items)

    def multi_clip_item(self, i):
        return self.items[i]


def synthetic_pretrain_batch(b, cfg, seed, device):
    """``b`` seeded uint8 clips and captions of 6 to size_txt tokens
    ([CLS] ... [SEP], zero-padded), with their padding mask."""
    rs = np.random.RandomState(seed)
    txt = np.zeros((b, cfg.size_txt), np.int32)
    for i in range(b):
        n = rs.randint(6, cfg.size_txt + 1)
        txt[i, :n] = rs.randint(1000, cfg.text.vocab_size, n)
        txt[i, 0], txt[i, n - 1] = 101, 102
    img = rs.randint(0, 256, (b, cfg.size_frame, cfg.size_img, cfg.size_img, 3))
    return {"img": torch.from_numpy(img.astype(np.uint8)).to(device),
            "txt": torch.from_numpy(txt).to(device),
            "mask": torch.from_numpy((txt > 0).astype(np.int32)).to(device)}


def build_optimizer(model, run):
    t = run.train
    return AdamW(model, t.lr, TRAIN_MAX_ITER, weight_decay=t.decay, betas=t.betas,
                 warmup_ratio=t.warmup_ratio, min_lr=t.min_lr, max_grad_norm=t.max_grad_norm,
                 backbone_lr_mul=t.vis_backbone_lr_mul)


def train_phase(dev, run):
    """Phase 6: the pretrain train step at full width. Returns the launch
    counts of the first timed step."""
    cfg = run.model
    b = run.train.size_batch
    model = VioletPretrain.from_run_config(run, dtype=torch.bfloat16, device=dev,
                                           seed=TRAIN_SEED)
    opt = build_optimizer(model, run)
    state = create_train_state(model, opt)
    step = make_pretrain_train_step(model, opt)
    batch = synthetic_pretrain_batch(b, cfg, seed=3, device=dev)
    before = {n: p.detach().clone() for n, p in state.params.items()}
    t0 = time.perf_counter()
    state, ls = step(state, batch, TRAIN_SEED)             # warm-up: first launches, cuBLAS
    torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0
    losses = [{k: v.item() for k, v in ls.items()}]
    torch.cuda.reset_peak_memory_stats(dev)
    secs, launches = [], {}
    for i in range(TRAIN_STEPS):
        if i == 0:
            _build.launch_counts.clear()
        t0 = time.perf_counter()
        state, ls = step(state, batch, TRAIN_SEED)
        torch.cuda.synchronize(dev)
        secs.append(time.perf_counter() - t0)
        if i == 0:
            launches = dict(_build.launch_counts)
        losses.append({k: v.item() for k, v in ls.items()})
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    clips_s = [b / t for t in secs]
    print(f"train-step launch counts: {launches}", flush=True)
    print(json.dumps({
        "slice": "pretrain_train_step", "config": PRETRAIN_CONFIG.name, "dtype": "bfloat16",
        "batch": b, "frames": cfg.size_frame, "size_img": cfg.size_img,
        "size_txt": cfg.size_txt, "steps": TRAIN_STEPS, "warmup_step_s": warm_s,
        "clips_per_s": float(np.median(clips_s)), "clips_per_s_range": [min(clips_s),
                                                                          max(clips_s)],
        "step_ms_median": float(np.median(secs)) * 1e3, "step_s_each": secs,
        "peak_mem_gib": peak, "losses_each_step": losses}), flush=True)
    for name, want in TRAIN_LAUNCHES.items():
        require(launches.get(name, 0) == want,
                f"{name} launched {launches.get(name, 0)} times in a train step, not {want}")
    require(launches.get("lane_self_attention", 0) == 0,
            "the train step ran attention without dropout")
    for i, step_ls in enumerate(losses):
        require(all(np.isfinite(v) for v in step_ls.values()),
                f"non-finite loss at step {i}: {step_ls}")
    no_grad = {n for n, p in state.params.items() if p.grad is None}
    require(no_grad == {"enc_img.emb_odr"},
            f"parameters without a gradient: {sorted(no_grad)} (expected only the "
            f"frame-order embedding, which the pretrain forward does not use)")
    unchanged = [n for n, p in state.params.items()
                 if n not in no_grad and torch.equal(before[n], p.detach())]
    require(not unchanged, f"parameters unchanged after {TRAIN_STEPS + 1} steps: {unchanged}")
    return launches


def whole_step_phase(dev, run):
    """Phase 7: one train step of a depth-cut copy, card fp32 (kernels)
    against CPU fp32 (plain versions)."""
    cfg = run.model
    cut = dataclasses.replace(
        cfg, swin_custom=dataclasses.replace(cfg.swin, depths=(2, 2, 2, 2),
                                             drop_path_rate=0.0),
        fusion=dataclasses.replace(cfg.fusion, num_hidden_layers=2, hidden_dropout_prob=0.0,
                                   attention_probs_dropout_prob=0.0),
        text=dataclasses.replace(cfg.text, hidden_dropout_prob=0.0))
    run_cut = dataclasses.replace(run, model=cut)
    b = 4
    batch = synthetic_pretrain_batch(b, cut, seed=4, device="cpu")
    gen = torch.Generator().manual_seed(5)
    ps = cut.size_patch
    hw = cut.size_img // ps
    draws = draw_masks(gen, batch["txt"], cut.size_frame, hw, hw,
                       special_token_ids=VioletPretrain.special_token_ids,
                       mask_token_id=VioletPretrain.mask_token_id, p_mask=run.train.p_mask,
                       mask_types=run.train.pretrain_masks)
    batch.update(draws=draws, neg_idx=draw_negatives(gen, b, 3))
    card = VioletPretrain.from_run_config(run_cut, dtype=torch.float32, device=dev, seed=1)
    cpu = VioletPretrain.from_run_config(run_cut, dtype=torch.float32, device="cpu", seed=1)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    results, secs = {}, {}
    for name, model, device in (("card", card, dev), ("cpu", cpu, torch.device("cpu"))):
        model.fc[0].p = 0.0                 # the score head's dropout, fixed at 0.1
        opt = build_optimizer(model, run)
        step = make_pretrain_train_step(model, opt)
        on_dev = {k: (type(v)(*(t.to(device) for t in v)) if k == "draws" else v.to(device))
                  for k, v in batch.items()}
        t0 = time.perf_counter()
        _, ls = step(create_train_state(model, opt), on_dev, 0)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        secs[name] = time.perf_counter() - t0
        results[name] = ({k: v.item() for k, v in ls.items()},
                         {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                          .detach().float().cpu() for n, p in model.named_parameters()})
    (ls_c, g_c), (ls_r, g_r) = results["card"], results["cpu"]
    tol = WHOLE_STEP_TOL
    g_all = max(g.abs().max().item() for g in g_r.values())
    worst, fails = [], []
    for n, g in g_r.items():
        d = (g_c[n] - g).abs().max().item()
        bound = tol["grad_scale"] * g.abs().max().item() + tol["grad_global"] * g_all
        worst.append((d / bound, n, d))
        if d > bound:
            fails.append(f"{n}: max diff {d:.3g} > {bound:.3g}")
    loss_diff = {k: abs(ls_c[k] - ls_r[k]) for k in ls_r}
    for k, d in loss_diff.items():
        if d > tol["loss_rtol"] * abs(ls_r[k]):
            fails.append(f"loss {k}: card {ls_c[k]} cpu {ls_r[k]}")
    worst.sort(reverse=True)
    print(json.dumps({"whole_step_vs_cpu": {
        "swin_depths": list(cut.swin.depths), "fusion_layers": cut.fusion.num_hidden_layers,
        "batch": b, "losses_card": ls_c, "losses_cpu": ls_r, "loss_abs_diff": loss_diff,
        "grad_global_max": g_all, "params": len(g_r), "step_s": secs,
        "worst_grads": [dict(param=n, max_abs_diff=d, fraction_of_limit=r)
                        for r, n, d in worst[:8]]}}), flush=True)
    require(not fails, "whole train step, card against CPU:\n" + "\n".join(fails))


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "the port's chip run needs a CUDA card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | count {torch.cuda.device_count()}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    so = _build.build(verbose=True)
    _build.library()
    print(f"build: {so.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    # 3. kernels against plain versions, at the main-path shapes; a limit
    # exceeded fails the run after the later phases have printed theirs
    gen = torch.Generator(dev).manual_seed(0)
    recs = (direct_cases(dev, gen, ITEMS * CLIPS, 5, "eval") + lane_case(dev, gen)
            + ln_cases(dev, gen, EVAL_LN, "eval")
            + direct_cases(dev, gen, TRAIN_B, TRAIN_T, "train")
            + ln_cases(dev, gen, TRAIN_LN, "train")
            + direct_bwd_cases(dev, gen) + lane_train_cases(dev, gen)
            + ln_bwd_cases(dev, gen))
    failures = [f for r in recs for f in r.pop("failures")]
    print(json.dumps({"kernel_shapes": recs}), flush=True)
    print(f"phase 3 done at {time.perf_counter() - t_start:.1f} s; "
          f"{len(failures)} limit(s) exceeded", flush=True)

    # 4. the retrieval eval at full width
    cfg = load_run_config(str(CONFIG)).model
    model = VioletRetrieval(cfg, dtype=torch.bfloat16, device=dev, seed=0)
    ds = SyntheticRetrievalDataset(ITEMS, CLIPS, cfg.size_frame, cfg.size_img,
                                   cfg.size_txt, cfg.text.vocab_size, seed=1)

    def run_eval():
        return retrieval_two_stage_eval(model, ds, chunk_size=CHUNK,
                                        encode_batch=ITEMS, device=dev)

    run_eval()                                  # warm-up: first launches, cuBLAS
    _build.launch_counts.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    metrics = run_eval()
    launches = dict(_build.launch_counts)
    runs = [metrics] + [run_eval() for _ in range(EVAL_REPEATS - 1)]
    clips_s = [m["_clips"] / m["_stage1_s"] for m in runs]
    pairs_s = [m["_pairs"] / m["_stage2_s"] for m in runs]
    print(f"eval launch counts: {launches}", flush=True)
    for name in EVAL_KERNELS:
        require(launches.get(name, 0) > 0, f"{name} was never launched on the eval path")
    for k in ("r1", "r5", "r10", "medr"):
        require(np.isfinite(metrics[k]), f"{k} is not finite: {metrics}")
        require(all(m[k] == metrics[k] for m in runs), f"{k} differs between evals")
    require(1.0 <= metrics["medr"] <= ITEMS and 0.0 <= metrics["r1"] <= 100.0,
            f"metrics out of range: {metrics}")
    print(json.dumps({
        "slice": "retrieval_two_stage_eval", "config": CONFIG.name, "dtype": "bfloat16",
        "captions": ITEMS, "videos": ITEMS, "clips_per_video": CLIPS,
        "encode_batch": ITEMS, "chunk_size": CHUNK, "evals": EVAL_REPEATS,
        "stage1_clips_per_s": float(np.median(clips_s)),
        "stage1_clips_per_s_range": [min(clips_s), max(clips_s)],
        "stage2_pairs_per_s": float(np.median(pairs_s)),
        "stage2_pairs_per_s_range": [min(pairs_s), max(pairs_s)],
        "stage1_clips_per_s_each": clips_s, "stage2_pairs_per_s_each": pairs_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        **{k: metrics[k] for k in ("r1", "r5", "r10", "medr")}}), flush=True)

    # 5. whole model: card fp32 (kernels) against CPU fp32 (plain versions)
    state = model.state_dict()
    rs = np.random.RandomState(2)
    img = torch.from_numpy(rs.randint(0, 256, (2, 1, cfg.size_frame, cfg.size_img,
                                               cfg.size_img, 3)).astype(np.uint8))
    txt = torch.from_numpy(np.stack([ds.items[i]["txt"] for i in range(2)]))
    mask = torch.from_numpy(np.stack([ds.items[i]["mask"] for i in range(2)]))
    vj, ti = [0, 1, 1, 0], [0, 0, 1, 1]

    def whole(m, device):
        with torch.inference_mode():
            fi, mi, ft, mt = m.encode(img.to(device), txt.to(device), mask.to(device))
            s = m.score_pairs(fi[vj], mi[vj], ft[ti], mt[ti])
        return [t.float().cpu() for t in (fi, ft, s)]

    bf16_out = whole(model, dev)
    del model
    torch.cuda.empty_cache()
    m32 = VioletRetrieval(cfg, dtype=torch.float32, device=dev)
    m32.load_state_dict(state)
    card = whole(m32, dev)
    del m32
    cpu = VioletRetrieval(cfg, dtype=torch.float32, device="cpu")
    cpu.load_state_dict(state)
    ref = whole(cpu, "cpu")
    diffs = {}
    for name, a, b16, r in zip(("feat_img", "feat_txt", "scores"), card, bf16_out, ref):
        torch.testing.assert_close(a, r, atol=1e-3, rtol=1e-3,
                                   msg=lambda m, name=name: f"whole model {name}: {m}")
        diffs[name] = {"fp32_max_abs": (a - r).abs().max().item(),
                       "bf16_max_abs": (b16 - r).abs().max().item(),
                       "ref_max_abs": r.abs().max().item()}
    print(json.dumps({"whole_model_vs_cpu": diffs}), flush=True)
    eval_launches = launches
    del cpu, card, ref
    torch.cuda.empty_cache()

    # 6. the pretrain train step at full width
    run = load_run_config(str(PRETRAIN_CONFIG))
    train_launches = train_phase(dev, run)
    torch.cuda.empty_cache()

    # 7. the whole train step, card fp32 against CPU fp32
    whole_step_phase(dev, run)

    require(not failures, "kernel checks failed:\n" + "\n".join(failures))

    # kernels line: per kernel, times summed over its main-path shapes (one
    # call of each), the largest fp32 error, and the launches of one train
    # step (one eval for the kernels the train step does not run)
    line = []
    for name, meta in KERNELS.items():
        mine = [r for r in recs if r["kernel"] == name]
        tot = {k: sum(r[k] for r in mine) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        ops_bound = sum(r["bound_ms"] for r in mine if r["bound_by"] == "operations")
        bf16 = {k: max(r[k] for r in mine) for k in mine[0]
                if k.startswith(("max_abs_err_bf16", "mismatch_bf16"))}
        line.append({"name": name, "route": "cuda", **meta,
                     "launches": train_launches.get(name) or eval_launches.get(name, 0),
                     "launches_train_step": train_launches.get(name, 0),
                     "launches_eval": eval_launches.get(name, 0),
                     "max_abs_err": max(r["max_abs_err"] for r in mine), **bf16,
                     "ms": tot["ms"], "kernel_ms": tot["ms"], "plain_ms": tot["plain_ms"],
                     "bound_ms": tot["bound_ms"],
                     "bound_by": "operations" if ops_bound > tot["bound_ms"] / 2 else "bytes",
                     "library_ms": tot["library_ms"], "shapes": len(mine)})
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
