#!/usr/bin/env python3
"""Drive the PyTorch port (empirical_mvm_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare-build OTHER/empirical_mvm_torch/csrc

The second form only compares kernels between this checkout's sources and
another's (for example the parent commit, unpacked with ``git archive``),
on one card, times in turns (``compare_builds``): the forwards whose bf16
runs a tensor-core body (rows 3, 7, 9, 10 and 12 on
csrc/attention_fwd_mma.cuh, row 5 on row 11's forward), fp32 bit for bit
and each build's bf16 held to the bf16 limits; the backwards whose bf16
runs a tensor-core body (rows 4, 8, 9 and 10 on csrc/attention_bwd_mma.cuh,
row 6 on row 11's body) and row 11 (the tiled self-attention) at the
multiple-choice shape, fp32 and bf16 bit for bit; the LayerNorm forward
and backward (rows 1 and 2) at every site of the paths, each build held to
the LayerNorm limits, new / base per site; and the pixel, violet,
2d_feature and swin2d train steps and the multiple-choice step at full
width, each build's steps timed in turns, with each step's kernel time
under torch.profiler, so that a change of kernel time shows in step time
on one card.

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
   lane self-attention, lane window attention) and the lane forward with
   dropout (same Philox seed as its plain version, compared element by
   element) are checked the same way. Each kernel, its plain version and one PyTorch library call
   computing the same function (SDPA with bias + mask as ``attn_mask``, and
   ``dropout_p`` for the dropout rows, its backward through autograd;
   ``F.layer_norm`` and its backward) are timed with CUDA events in the
   main path's dtype. The LayerNorm records also name the body each dtype
   ran (``vectorized`` at the paths' widths, ``scalar`` elsewhere), hold
   the bf16 limits at rows of mean 50 and std 1 (``LARGE_MEAN``), give the
   device time of one kernel call and one ``F.layer_norm`` call under the
   profiler (``device_ms``, ``library_device_ms``), and the backward's
   dgamma and dbeta must be bit-identical over two runs; three copies of
   layer_norm.cu with planted faults (``PLANTED_LN``: a one-pass variance,
   the m2 term dropped from dx, a partial left out of dgamma and dbeta)
   must each fail the LayerNorm limits at the train fusion site. The forward kernels are checked and timed at the
   eval's shapes and at the train step's; ``lane_window_attention`` and the
   LayerNorm at the frozen 2D teacher's shapes of the 2d_feature step, and
   ``lane_window_attention_bwd`` at the trained 2D swin's shapes of the
   swin2d step (the same seven (window, head) shapes);
   ``packed_window_attention`` and its backward at the C = 96 Video Swin's
   stages 0 and 1 of the violet step (N = 196), unshifted and shifted, and
   at stage 0 of the 2D Swin-tiny (N = 49, not on a path of this script);
   ``fused_window_attention`` (q, k, v as three arrays, the same kernel)
   and its backward at the violet stage-0 shifted shape; the direct kernels
   forward and backward at the violet step's stages 2 and 3 (C = 384, 768);
   ``packed_self_attention`` (the tiled self-attention) forward at p = 0 and
   p = 0.1 and its backward at the multiple-choice fusion shape, with the
   dropout keep fraction, at DPT-Large's 384^2 shape (fp32 and bf16) and at
   N = 129, ``fused_self_attention`` (the same kernel on q, k, v apart),
   and two copies of csrc/ with planted faults of the tensor-core bodies
   (``PLANTED_TILED``: two of row 11's, the forward one also held at row
   5, one of the window backward's, one of row 6's, one of the window
   forward's held at rows 3, 7, 9 and 12), each of which must fail the bf16
   limits. The records of rows 3-12 name the body each dtype ran
   (``tensor_core`` for bf16 at the paths' head widths, ``cuda_core`` for
   fp32); the window forwards' bf16 (rows 3, 7, 9, 10, 12) is held to the
   ``window_fwd_tc`` limits, row 5's to row 11's ``sa``, the window
   backwards' to ``window_bwd_tc``. The LayerNorm at
   the 3D teacher's final norm and at the CLIP teacher's sites,
   ``lane_self_attention`` at the CLIP teacher's shape (80 frames of 50
   tokens, p = 0); ``lane_attention`` (row 12, the
   lanebench tool's kernel) at the tool's three stage shapes with its zero
   mask and a seeded shift-like mask, each beside row 7's time on the same
   inputs; and, marked ``off_path``, what the C % 128 rule costs at the
   violet stages 0-1: rows 12 and 7 on the partitioned windows against
   ``_to_packed`` + row 9 + ``_from_packed``. Prints one
   ``kernel_shapes`` line with the per-shape numbers and, at the end, one
   ``kernels`` JSON line.
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
   finite and every parameter that gets a gradient must have changed (the
   VTM score head's output bias may instead have an all-zero gradient).
7. Whole train step: one step of a depth-cut copy (swin depths (2,2,2,2),
   2 fusion layers, full widths) on the card in fp32 against the same step
   on the CPU in fp32 (plain versions), with the same injected masks and
   negatives and every dropout and drop-path rate at 0; losses and every
   parameter's gradient held to ``WHOLE_STEP_TOL``, the differences printed.
8. The pretrain train step for the 2d_feature MVM target, as phase 6 with
   ``train.mvm_target`` replaced by ("2d_feature",) (as bench.py builds
   it): the frozen 2D Swin-base teacher runs forward on the unmasked clip
   (the ``lane_window_attention`` kernel, bf16 on the tensor-core window
   body, in its 24 blocks, kernel
   LayerNorms at its 52 sites), and 4-group AdamW leaves it out. Launches of
   one step held to ``TRAIN_2D_LAUNCHES``; the teacher gets no gradient and
   stays bit-unchanged; every other parameter with a gradient changes.
9. Whole 2d_feature train step: phase 7 for the run of phase 8 (the
   student cut, the teacher at full depth).
10. The pretrain train step on the trained 2D Swin-base backbone, as phase 6
   with ``model.vis_backbone`` = "swin2d" and ``model.temporal_fusion`` =
   "concat" replaced in code (pixel MVM): the per-frame 2D swin runs the
   lane window kernel forward and backward in its 24 blocks, then
   ``swin2bert`` and the ``EncImgSwin`` embeddings. Launches of one step
   held to ``TRAIN_SWIN2D_LAUNCHES``.
11. Whole swin2d train step: phase 7 for the run of phase 10 (swin depths
   (2, 2, 2, 2) at the 2D geometry).
12. The pretrain train step on the C = 96 Video Swin, as phase 6 with
   ``model.vis_backbone_size`` = "violet" replaced in code (the reference's
   ``swin_violet.py``: embed 96, depths 2/2/18/2, heads 3/6/12/24): its
   stage-0 and stage-1 blocks (C = 96, 192) run the packed window kernel
   forward and backward, stages 2 and 3 the direct kernels. Launches of one
   step held to ``TRAIN_VIOLET_LAUNCHES``.
13. Whole violet train step: phase 7 for the run of phase 12 (swin depths
   (2, 2, 2, 2) at the violet widths).
14. The multiple-choice QA fine-tune step at full width: VioletQAMC at
   configs/msrvtt-mc.json (Swin-base on 5 frames of 224^2, 8 questions of 5
   options of 100 text tokens, so the 12-layer BERT-base fusion runs 40 rows
   of 350 tokens on the tiled self-attention), seeded random weights, bf16,
   the ``ce`` step of ``make_supervised_train_step`` with the package's
   ``build_optimizer``. One warm-up step, then ``TRAIN_STEPS`` timed steps:
   questions/s (batch / step seconds) median and range, peak device memory,
   every loss finite; the launches of the first timed step held to
   ``TRAIN_QAMC_LAUNCHES`` (12 + 12 tiled launches, no lane
   self-attention); every parameter with a gradient changed (the score
   head's output bias may instead have an all-zero gradient).
15. Whole multiple-choice step: a depth-cut copy (swin depths (2, 2, 2, 2),
   2 fusion layers, batch 2, every rate 0) at full widths and L = 350, card
   fp32 against CPU fp32, as phase 7; the score head's output bias, whose
   gradient is zero in exact arithmetic, is held to ``ZERO_GRAD_ATOL`` on
   each side.
16. The multiple-choice eval: ``make_eval_step`` on the trained model of
   phase 14 over ``QAMC_EVAL_BATCHES`` seeded batches, ``qamc_accuracy``;
   each batch launches ``EVAL_QAMC_LAUNCHES``.
17. The lanebench tool, ``empirical_mvm_torch.tools.lanebench.main(
   ["--stage", "-1", "--grad"])`` in this process: its lines; each path's
   error against the tool's fp32 oracle within phase 3's bf16 limit against
   plain fp32 (``BF16_VS_FP32["attention"]``, which the ``window_fwd_tc``
   kind of the tool's bodies shares); ``lane_attention`` launched (its counts are the kernels line's
   ``launches_lanebench``).
18-20. The pretrain train step at full width for the 3d_feature (the
   frozen Video Swin-base teacher: the direct kernel in its 24 blocks, the
   kernel LayerNorm at its 53 sites), 2d_clip (the frozen CLIP ViT-B/32 on
   each frame: lane_self_attention in its 12 layers, 25 LayerNorm sites)
   and hog targets, each as phase 6 with ``train.mvm_target`` replaced;
   launches held to ``TRAIN_3D_LAUNCHES``, ``TRAIN_CLIP_LAUNCHES`` and
   ``TRAIN_HOG_LAUNCHES``; the teachers get no gradient and stay
   bit-unchanged; the device time of one no-grad call of each teacher and
   of ``hog_image`` printed.
21. Whole train step for ("hog", "3d_feature", "2d_clip"): phase 7 for that
   run (the student cut, both teachers at full depth), both sides fed one
   hog target computed on the CPU; ``hog_image`` itself held card against
   CPU apart (``HOG_FLIP_SHARE``, ``HOG_CELL_SCALE``).
22. The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import functools
import itertools
import json
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from empirical_mvm_torch.core.config import SwinConfig, load_run_config
from empirical_mvm_torch.data.masking import draw_masks
from empirical_mvm_torch.models.encoders2d import swin2d_config
from empirical_mvm_torch.models.pretrain import VioletPretrain, draw_negatives
from empirical_mvm_torch.models.tasks import VioletQAMC, VioletRetrieval
from empirical_mvm_torch.models.video_swin import (_from_packed, _shift_attn_mask, _to_packed,
                                                  get_window_size)
from empirical_mvm_torch.ops import _build
from empirical_mvm_torch.ops import layernorm as ln
from empirical_mvm_torch.ops import window_attention as wa
from empirical_mvm_torch.ops.hog import hog_bins, hog_image
from empirical_mvm_torch.ops.preprocess import maybe_normalize
from empirical_mvm_torch.teachers.clip import renormalize_imagenet_to_clip
from empirical_mvm_torch.tools import lanebench
from empirical_mvm_torch.train.evaluators import qamc_accuracy, retrieval_two_stage_eval
from empirical_mvm_torch.train.optimizer import build_optimizer
from empirical_mvm_torch.train.train_step import (create_train_state, make_eval_step,
                                                  make_pretrain_train_step,
                                                  make_supervised_train_step)

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs" / "msrvtt-retrieval.json"
PRETRAIN_CONFIG = REPO / "configs" / "pretrain.json"
QAMC_CONFIG = REPO / "configs" / "msrvtt-mc.json"

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
# LayerNorm sites (label, rows, C, eps, dtype). Eval: fusion layers (CHUNK
# x 275 rows), EncVideo.norm (32 clips x 250), text embeddings (ITEMS x 25,
# fp32: the embedding sum stays fp32). Train step: fusion (80 x 232),
# EncVideo (20 x 4 x 50), text embeddings and MLM head (20 x 32). The frozen
# 2D teacher of the 2d_feature step (20 clips x 4 frames at 224^2, its
# grid 56 >> stage): the patch norm and the stage blocks' norm1/norm2, and
# the merge norms over 4C.
EVAL_LN = (("fusion", CHUNK * 275, 768, 1e-12, torch.bfloat16),
           ("enc_video", ITEMS * CLIPS * 250, 768, 1e-5, torch.bfloat16),
           ("embeddings", ITEMS * 25, 768, 1e-12, torch.float32))
TRAIN_LN = (("fusion", 80 * 232, 768, 1e-12, torch.bfloat16),
            ("enc_video", 20 * 4 * 50, 768, 1e-5, torch.bfloat16),
            ("embeddings", 20 * 32, 768, 1e-12, torch.float32),
            ("mlm_head", 20 * 32, 768, 1e-12, torch.bfloat16))
TEACHER_LN = tuple((f"teacher stage{s} norms", 80 * (56 >> s) ** 2, 128 << s, 1e-5,
                    torch.bfloat16) for s in range(4)) + tuple(
    (f"teacher merge{s}", 80 * (28 >> s) ** 2, 512 << s, 1e-5, torch.bfloat16)
    for s in range(3))
# the 3d_feature step's frozen Video Swin-base teacher (phase 18) has the 2D
# teacher's sites (the same rows: 20 clips x 4 frames at 56 >> stage) and a
# final norm; the 2d_clip step's CLIP ViT-B/32 (phase 19) normalizes 80
# frames of 50 tokens (pre_ln, then ln1 and ln2 in each of 12 layers)
TEACHER3D_LN = TEACHER_LN + (("teacher final norm", 80 * 49, 1024, 1e-5, torch.bfloat16),)
CLIP_LN = (("clip pre_ln/ln1/ln2", 80 * 50, 768, 1e-5, torch.bfloat16),)
# Each LayerNorm site is also held, in bf16, at rows of mean 50 and std 1
# (LARGE_MEAN), where a one-pass variance, E[x^2] - mean^2, cancels about
# 11 bits and fails the bf16 limits (tests/test_torch_layernorm_body.py). In
# bf16 these values are multiples of 1/4, which the fp32 sums add exactly,
# so the check reads the variance alone; in fp32, sums of 768 values near 50
# round by about 1e-5 in any order, the plain version's too, which is the
# fp32 limit itself.
LARGE_MEAN = (50.0, 1.0)
# launches of one train step: LayerNorm at 24 fusion sites + EncVideo +
# embeddings + MLM head; a swin attention in each of the 24 blocks; one
# fusion attention in each of the 12 layers
TRAIN_LAUNCHES = {"fused_layer_norm": 27, "fused_layer_norm_bwd": 27,
                  "direct_window_attention": 24, "direct_window_attention_bwd": 24,
                  "lane_self_attention_dropout": 12, "lane_self_attention_bwd": 12}
# the 2d_feature step adds the frozen 2D Swin-base teacher, forward only: a
# lane window attention in each of its 24 blocks, and the kernel
# LayerNorm at its 52 sites (patch norm, 2 x 24 block norms, 3 merge norms)
TRAIN_2D_LAUNCHES = {**TRAIN_LAUNCHES, "fused_layer_norm": 27 + 52,
                     "lane_window_attention": 24}
# the swin2d step (phase 10): the student's 24 blocks run the lane window
# kernel forward and backward instead of the direct kernels; its LayerNorms
# stay plain, and the kernel LayerNorm keeps its 27 sites (EncImgSwin's
# embeddings norm in place of EncVideo's)
TRAIN_SWIN2D_LAUNCHES = {"fused_layer_norm": 27, "fused_layer_norm_bwd": 27,
                         "lane_window_attention": 24, "lane_window_attention_bwd": 24,
                         "lane_self_attention_dropout": 12, "lane_self_attention_bwd": 12}
# the violet step (phase 12): the C = 96 Video Swin's 4 blocks of stages 0
# and 1 (C = 96, 192: no multiple of 128) run the packed kernel, its 20
# blocks of stages 2 and 3 the direct kernels; the rest as the pixel step
TRAIN_VIOLET_LAUNCHES = {**TRAIN_LAUNCHES, "direct_window_attention": 20,
                         "direct_window_attention_bwd": 20, "packed_window_attention": 4,
                         "packed_window_attention_bwd": 4}
# the 3d_feature step (phase 18) adds the frozen Video Swin-base teacher,
# forward only: a direct window attention in each of its 24 blocks, and the
# kernel LayerNorm at its 53 sites (the 2D teacher's 52 and a final norm)
TRAIN_3D_LAUNCHES = {**TRAIN_LAUNCHES, "fused_layer_norm": 27 + 53,
                     "direct_window_attention": 24 + 24}
# the 2d_clip step (phase 19) adds the frozen CLIP ViT-B/32 on 80 frames of
# 50 tokens: lane_self_attention (p = 0, lane_sa_attention_fits) in each of
# its 12 layers, the kernel LayerNorm at pre_ln and 2 x 12 layer sites (the
# post LayerNorm reads the pooled CLS token, which the target does not use)
TRAIN_CLIP_LAUNCHES = {**TRAIN_LAUNCHES, "fused_layer_norm": 27 + 1 + 2 * 12,
                       "lane_self_attention": 12}
# the hog step (phase 20): HOG is torch ops; the kernels are the pixel step's
TRAIN_HOG_LAUNCHES = dict(TRAIN_LAUNCHES)
# MVM targets whose model holds a frozen teacher
TEACHER_TARGETS = {"2d_feature", "3d_feature", "2d_clip"}
EVAL_KERNELS = ("fused_layer_norm", "direct_window_attention", "lane_self_attention")
# The multiple-choice fine-tune step of configs/msrvtt-mc.json (phase 14):
# batch 8 questions of 5 options over 5 frames of 224^2, so the fusion runs
# 40 rows of L = 5 * 50 + 100 = 350 tokens, which lane_sa_attention_fits
# refuses: its 12 layers take the tiled self-attention (row 11) forward with
# dropout and backward, and no lane_self_attention. LayerNorm: 24 fusion
# sites, EncVideo and the text embeddings; the swin's 24 blocks the direct
# kernels (N = 245). The eval (phase 16) runs the forwards of one step.
QAMC_B, QAMC_O, QAMC_L = 8, 5, 350
TRAIN_QAMC_LAUNCHES = {"fused_layer_norm": 26, "fused_layer_norm_bwd": 26,
                       "direct_window_attention": 24, "direct_window_attention_bwd": 24,
                       "packed_self_attention": 12, "packed_self_attention_bwd": 12}
EVAL_QAMC_LAUNCHES = {"fused_layer_norm": 26, "direct_window_attention": 24,
                      "packed_self_attention": 12}
QAMC_EVAL_BATCHES = 4

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
# the backward of fused_window_attention returns dq, dk and dv apart: each
# is held as the backward's dx3
for _lim in (FP32_LIMITS, BF16_LIMITS):
    _lim["attention_bwd_qkv"] = {**{g: _lim["attention_bwd"]["dx3"] for g in ("dq", "dk", "dv")},
                                 "dbias": _lim["attention_bwd"]["dbias"]}
    # the tiled self-attention's backward: dqkv (packed) or dq, dk, dv
    # (split), no bias, each held as the backward's dx3
    _lim["sa_bwd"] = {"dqkv": _lim["attention_bwd"]["dx3"]}
    _lim["sa_bwd_qkv"] = {g: _lim["attention_bwd"]["dx3"] for g in ("dq", "dk", "dv")}
# the tiled self-attention's forward ("sa"): as attention, but against plain
# bf16 one bf16 step plus 1e-3 of the output's scale, the backward's term for
# an inner rounding that falls the other way. Some fp32 probabilities of
# the plain softmax and of the kernel's exp(s - max) / sum differ in their
# last bit (the exp and the division are not torch's); a
# p that then rounds the other way in bf16 moves an output that cancels to
# near 0 by ulp(p) |v|, above one bf16 step of that output (at N = 577,
# tests/test_torch_self_attention.py holds the kernel's arithmetic, emulated,
# to this limit). A dropped rounding still moves far more than
# BF16_MISMATCH of the elements.
# Row 11's mismatch share: its bf16 body (hd 32, 64, 128) sums the scores
# on the tensor cores, in another order than the plain version's fp32 chain,
# so some fp32 scores differ in their last bit and a p near a bf16 rounding
# boundary rounds the other way; each such p moves outputs by a step. On
# the H100 that moves 1.12e-3 of the forward's outputs and 1.38e-3 of dq,
# dk and dv at N = 577, 6.6e-4 and 7.6e-4 at the multiple-choice shape,
# where the CUDA-core body reads 3.4e-4 and 3.0e-4 (PERF.md); the CPU
# emulation of the new order reads the same (tests/test_torch_self_attention.py).
# SA_MISMATCH is about twice the largest reading; the planted faults of row
# 11 move 13-51 % of the elements.
SA_MISMATCH = 3e-3
FP32_LIMITS["sa"] = FP32_LIMITS["attention"]
BF16_LIMITS["sa"] = {"out": (BF16_VS_FP32["attention"],
                             dict(atol=1e-5, rtol=2.0 ** -7, scale=1e-3), SA_MISMATCH)}
BF16_LIMITS["sa_bwd"] = {"dqkv": BF16_LIMITS["attention_bwd"]["dx3"][:2] + (SA_MISMATCH,)}
BF16_LIMITS["sa_bwd_qkv"] = {g: BF16_LIMITS["sa_bwd"]["dqkv"] for g in ("dq", "dk", "dv")}
# The window-attention backward's tensor-core body (rows 4, 8, 9, 10 in
# bf16 at hd 32, csrc/attention_bwd_mma.cuh; kind "window_bwd_tc"): against
# plain bf16 one bf16 step plus WINDOW_TC_STEP_SCALE of the output's scale.
# Its scores and dp sum on the tensor cores, in another order than the plain
# version's fp32 chains (and with the tensor cores' own alignment of the
# products, which torch's CPU sums do not reproduce: the CPU emulation in
# tests/test_torch_bwd_mma.py reads no element over one step at N = 196), so
# a p near a bf16 rounding boundary may round the other way and move a dv
# element by ulp(p) |do|: with N = 49 and a shift mask, p reaches 1/2 and
# |do| 4. On the H100 the largest reading is 1.03e-3 of dx3's scale (2D swin
# stage 1, shifted; 1.6e-5 of the elements above one step, PERF.md), above
# the CUDA-core body's 1e-3; the limit is about three times that. The
# mismatch share (BF16_BWD_MISMATCH) and the dbias limits are the CUDA-core
# body's: the planted fault of the body (ds rounded before dbias) moves
# dbias far past 1e-4 of its scale.
WINDOW_TC_STEP_SCALE = 3e-3
FP32_LIMITS["window_bwd_tc"] = FP32_LIMITS["attention_bwd"]
FP32_LIMITS["window_bwd_tc_qkv"] = FP32_LIMITS["attention_bwd_qkv"]
BF16_LIMITS["window_bwd_tc"] = {
    "dx3": (dict(scale=2e-2), dict(rtol=2.0 ** -7, scale=WINDOW_TC_STEP_SCALE),
            BF16_BWD_MISMATCH),
    "dbias": BF16_LIMITS["attention_bwd"]["dbias"]}
BF16_LIMITS["window_bwd_tc_qkv"] = {
    **{g: BF16_LIMITS["window_bwd_tc"]["dx3"] for g in ("dq", "dk", "dv")},
    "dbias": BF16_LIMITS["attention_bwd"]["dbias"]}
# The window forwards' tensor-core body (rows 3, 7, 9, 10, 12 in bf16 at hd
# 32, csrc/attention_fwd_mma.cuh; kind "window_fwd_tc"): row 11's forward
# limits (``sa``) with a wider scale term, for row 11's reason. Its scores sum on the tensor cores, in
# another order than the plain version's fp32 chain, and its row sums over
# the lanes and a warp butterfly, so a p near a bf16 rounding boundary may
# round the other way and move an output that cancels to near 0 by ulp(p)
# |v|, above one bf16 step of that output. The CPU emulation
# (tests/test_torch_fwd_mma.py) exceeds the CUDA-core one-step limit by up
# to 1.5e-5 (1.6e-4 of the elements over a step) and differs from plain
# bf16 in up to 8.3e-4 of the elements, near BF16_MISMATCH. On the H100 the
# body exceeds one step by up to 2.5e-4 at the N = 196 and 245 shapes, 5.0e-4
# at N = 49 with the shift mask (rows 7 and 9), at under 3e-5 of the
# elements, and up to 3.8e-4 of its elements differ. The planted fault of
# the body moves 55 % of the elements.
# The scale term is derived from the body's arithmetic at N = 49 with the
# shift mask, its tightest case: a query of a shifted 7 x 7 window sees at
# least the 9 keys of the 3 x 3 corner region, and with the paths' scores
# (bias 0.02, q.k of bf16 values of std 0.5 at hd 32) no p reaches 1/4, so
# the bf16 step of a p that rounds the other way is at most ulp(1/8) =
# 2^-10; an output averages 9 or more values of v, so its scale is about
# 1/sqrt(9) of the largest |v|, and the flipped p moves it by at most ulp(p)
# |v| = 3 * 2^-10 = 2.9e-3 of that scale. On the H100 the largest reading is
# 7.27e-4 over one step at an output scale of 0.71, 1.03e-3 of the scale
# (row 9 at the 2D Swin-tiny stage-0 shifted shape, in two builds of the
# body alike; PERF.md), which the 1e-3 of ``sa`` missed by 2.0e-5. The
# term stays under the backward's WINDOW_TC_STEP_SCALE; the mismatch share
# stays SA_MISMATCH, and the planted fault of the body (52-55 % of the
# outputs) fails it still.
WINDOW_FWD_TC_STEP_SCALE = 3 * 2.0 ** -10
FP32_LIMITS["window_fwd_tc"] = FP32_LIMITS["attention"]
BF16_LIMITS["window_fwd_tc"] = {"out": (
    BF16_VS_FP32["attention"],
    dict(atol=1e-5, rtol=2.0 ** -7, scale=WINDOW_FWD_TC_STEP_SCALE), SA_MISMATCH)}
OUTPUTS = {kind: tuple(lim) for kind, lim in FP32_LIMITS.items()}
# dropout keep fraction: 1 - p within 5 binomial standard deviations
KEEP_SIGMAS = 5.0
# the whole train step, card fp32 against CPU fp32: losses at rtol 1e-4;
# each gradient within 2e-3 of its own largest value plus 1e-6 of the
# largest gradient anywhere (summation orders through 8 swin blocks, 2
# fusion layers and the heads; the floor covers gradients that are zero in
# exact arithmetic, such as the key biases under the shift-invariant softmax)
WHOLE_STEP_TOL = dict(loss_rtol=1e-4, grad_scale=2e-3, grad_global=1e-6)
# The multiple-choice score head's output bias adds the same value to every
# option, so the cross entropy over the options gives it a gradient of 0 in
# exact arithmetic; each side's reads as fp32 roundoff of sums of 10 rows of
# O(1) (about 1e-7 on an H100), held to this bound rather than to the
# other side's roundoff, which the floor of WHOLE_STEP_TOL (1e-6 of a largest
# gradient of 0.12) does not cover.
ZERO_GRAD_ATOL = 1e-6

# hog_image, card against CPU on the same normalized clips (phase 21): a
# pixel falls in another orientation bin only where its angle lies within
# the last bit of atan2 and of the division of a bin edge: at most
# HOG_FLIP_SHARE of the pixels may. In the cells where no pixel changed bin,
# the rendering may differ by HOG_CELL_SCALE of its largest value (hypot and
# atan2 to the last bit, 64-term fp32 sums in another order).
HOG_FLIP_SHARE = 1e-4
HOG_CELL_SCALE = 1e-5

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
    "lane_window_attention": dict(
        source="empirical_mvm_torch/csrc/lane_window_attention.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:810"),
    "lane_window_attention_bwd": dict(
        source="empirical_mvm_torch/csrc/lane_window_attention.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:853"),
    # rows 9 and 10 run one pair of kernel bodies (`_attn_kernel` :69,
    # `_attn_bwd_kernel` :109); named here by their pallas_call sites
    "packed_window_attention": dict(
        source="empirical_mvm_torch/csrc/packed_window_attention.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:383"),
    "packed_window_attention_bwd": dict(
        source="empirical_mvm_torch/csrc/packed_window_attention.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:411"),
    "fused_window_attention": dict(
        source="empirical_mvm_torch/csrc/packed_window_attention.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:232"),
    "fused_window_attention_bwd": dict(
        source="empirical_mvm_torch/csrc/packed_window_attention.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:259"),
    # row 11: both entries run `_sa_call`'s two pallas_calls (`_sa_kernel`
    # :460, `_sa_bwd_kernel` :483)
    "packed_self_attention": dict(
        source="empirical_mvm_torch/csrc/self_attention_tiled.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:593"),
    "packed_self_attention_bwd": dict(
        source="empirical_mvm_torch/csrc/self_attention_tiled.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:607"),
    "fused_self_attention": dict(
        source="empirical_mvm_torch/csrc/self_attention_tiled.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:593"),
    "fused_self_attention_bwd": dict(
        source="empirical_mvm_torch/csrc/self_attention_tiled.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:607"),
    # row 12: the lanebench tool's `_lane_kernel` (its pallas_call at :80)
    "lane_attention": dict(
        source="empirical_mvm_torch/csrc/lane_window_attention.cu",
        replaces="tools/lanebench.py:38"),
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
        if "scale" in same:
            # how much of the limit's scale term is used: the largest excess
            # over one bf16 step of the element, and the share of elements
            # above that step
            over_step = d16 - BF16_SAME_ROUNDING["atol"] - BF16_SAME_ROUNDING["rtol"] * r16.abs()
            readings.update({f"over_one_step_bf16{tag}": over_step.max().item(),
                             f"share_over_one_step_bf16{tag}": (over_step > 0).float()
                             .mean().item()})
            del over_step
        del d32, d16
    return readings, failures


def fp32_check(kernel, plain, act, kind):
    """Hold each output of ``kernel(act)`` against ``plain(act)`` (fp32) with
    the limits of ``FP32_LIMITS[kind]``. Returns the largest error of each
    output and the list of limits exceeded."""
    errs, failures = {}, []
    for out_name, out, ref in zip(OUTPUTS[kind], _tuple(kernel(act)), _tuple(plain(act))):
        errs[out_name] = (out - ref).abs().max().item()
        over = _excess((out - ref).abs(), ref, **FP32_LIMITS[kind][out_name])
        if over > 0:
            failures.append(f"{out_name} fp32 max err {errs[out_name]} exceeds "
                            f"{FP32_LIMITS[kind][out_name]} by {over:.3g}")
    return errs, failures


def full_check(kernel, plain, act, kind):
    """``fp32_check`` and ``bf16_check`` together: (readings, failures)."""
    errs, failures = fp32_check(kernel, plain, act, kind)
    readings, bf16_failures = bf16_check(kernel, plain, act, kind)
    return {"max_abs_err_fp32": errs, **readings}, failures + bf16_failures


def measure(name, label, act, kernel, plain, library, work_dtype, kind, ops, ops_peak,
            nbytes):
    """Check ``kernel(act)`` against ``plain(act)`` in fp32 and bf16, then
    time kernel, plain and library in ``work_dtype``. ``library(a)`` returns
    a zero-argument callable, its inputs prepared outside the timed call.
    The record's ``failures`` lists the limits exceeded."""
    errs, failures = fp32_check(kernel, plain, act, kind)
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


def _window_bwd_kind(hd, split=False):
    """The limits of a window-attention backward record: those of its bf16
    body (``window_bwd_tc`` for the tensor cores), dq, dk, dv apart when
    ``split``."""
    tc = wa._window_bwd_body(torch.bfloat16, hd) == "tensor_core"
    return ("window_bwd_tc" if tc else "attention_bwd") + ("_qkv" if split else "")


def _window_fwd_kind(hd, n):
    """The limits of a window forward record (rows 3, 7, 9, 10, 12):
    ``window_fwd_tc`` where its bf16 runs the tensor-core body."""
    tc = wa._window_fwd_body(torch.bfloat16, hd, n) == "tensor_core"
    return "window_fwd_tc" if tc else "attention"


def _lane_fwd_kind(hd):
    """The limits of a lane self-attention forward record (row 5): row 11's
    ``sa`` where its bf16 runs row 11's tensor-core forward."""
    return "sa" if wa._sa_body(torch.bfloat16, hd) == "tensor_core" else "attention"


def _bodies(rule, *shape):
    """The body each dtype of a record ran (fp32 in the check against
    plain, bf16 in the bf16 check and the timing), by the C entries' rule
    (``rule(dtype, *shape)``)."""
    return {str(dt)[6:]: rule(dt, *shape) for dt in (torch.float32, torch.bfloat16)}


def _direct_sdpa(a, win, b, nw, nh):
    """q, k, v of SDPA on (B, nW * nH, N, hd) from the 5D x3 map: a clip's
    windows and heads on one axis (4D, which SDPA's fused kernels take)."""
    xw = wa.window_partition(a, win)                            # (B * nW, N, 3C)
    n, hd = xw.shape[1], xw.shape[2] // (3 * nh)
    qkv = xw.reshape(b, nw, n, 3, nh, hd).permute(3, 0, 1, 4, 2, 5)
    return qkv.reshape(3, b, nw * nh, n, hd).contiguous().unbind(0)


def direct_cases(dev, gen, b, t, path, swin=SwinConfig.base(), stages=range(4)):
    """The student's swin stages ``stages`` (of ``swin``'s widths), ``b``
    clips of ``t`` frames at 224^2: the eval at msrvtt-retrieval (32 clips,
    T = 5: the window clamps to (5, 7, 7), N = 245), the train step (20
    clips, T = 4: N = 196) and the violet step's stages 2 and 3 (the C = 96
    swin's C = 384 and 768, the direct kernel's stages there); hd = 32."""
    recs = []
    for stage in stages:
        hw, c, nh = 56 >> stage, swin.embed_dim << stage, swin.num_heads[stage]
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

            def library(a, mask=mask, nw=nw):
                q, k, v = _direct_sdpa(a, win, b, nw, nh)
                m = _window_sdpa_mask(bias, mask, nw, a.dtype)
                return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                                              scale=scale)

            label = f"{path} stage{stage} x3=({b},{t},{hp},{hp},{3 * c}) nH={nh} " + (
                "shifted" if mask is not None else "unshifted")
            ops = 4 * b * nw * nh * n * n * (c // nh)
            nbytes = x3.numel() * 2 + b * t * hp * hp * c * 2 + bias.numel() * 4 + (
                0 if mask is None else mask.numel() * 4)
            recs.append(measure("direct_window_attention", label, x3, kernel, plain,
                                library, torch.bfloat16, _window_fwd_kind(c // nh, n), ops,
                                "bf16_tensor", nbytes))
            recs[-1]["body"] = _bodies(wa._window_fwd_body, c // nh, n)
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
                  plain, library, torch.bfloat16, _lane_fwd_kind(d // nh), ops, "bf16_tensor",
                  nbytes)
    rec["body"] = _bodies(wa._sa_body, d // nh)
    return [rec]


def _ln_record(rec, kind, calls, x, large, c, work):
    """Complete a LayerNorm record: the body each dtype ran, the bf16 check
    at the ``LARGE_MEAN`` rows ``large``, and the device time of one call of
    the kernel and of the library call under the profiler (``device_ms``,
    ``library_device_ms``: the phase's ``ms`` is host-bound at the small
    sites)."""
    kernel, plain, library = calls
    readings, failures = bf16_check(kernel, plain, large, kind)
    rec["large_mean"] = readings
    rec["failures"] += [f"{rec['kernel']} [{rec['shape']}] large mean: {f}" for f in failures]
    rec["body"] = _bodies(functools.partial(ln._ln_body, backward=kind == "layer_norm_bwd"), c)
    a = x.to(work)
    lib_call = library(a)
    rec["device_ms"] = _device_ms(lambda: kernel(a))
    rec["library_device_ms"] = _device_ms(lib_call)
    del lib_call
    return rec


def _device_ms(fn, calls=20):
    """Device time of one call of ``fn``: its CUDA kernels' time under
    torch.profiler over ``calls`` calls, after one warm-up call."""
    fn()

    def run():
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()

    return _kernel_ms(run) / calls


def _ln_inputs(dev, gen, rows, c):
    """x (rows, C) of mean 0.5 and std 2, the same at ``LARGE_MEAN``, gamma,
    beta."""
    x = torch.randn(rows, c, device=dev, generator=gen) * 2.0 + 0.5
    large = torch.randn(rows, c, device=dev, generator=gen) * LARGE_MEAN[1] + LARGE_MEAN[0]
    g = 1.0 + 0.1 * torch.randn(c, device=dev, generator=gen)
    bt = 0.1 * torch.randn(c, device=dev, generator=gen)
    return x, large, g, bt


def _ln_fwd_calls(g, bt, eps, c):
    """(kernel, plain, library) of the LayerNorm forward with gamma, beta."""

    def kernel(a):
        return ln.fused_layer_norm(a, g, bt, eps)

    def plain(a):
        return ln.layer_norm_reference(a, g, bt, eps)

    def library(a):
        gw, bw = g.to(a.dtype), bt.to(a.dtype)
        return lambda: F.layer_norm(a, (c,), gw, bw, eps)

    return kernel, plain, library


def _ln_bwd_calls(g, dy, eps, c):
    """(kernel, plain, library) of the LayerNorm backward with gamma and
    the cotangent dy (bf16 values); dy is cast to each dtype once, outside
    the timed calls."""
    dys = {}

    def kernel(a):
        if a.dtype not in dys:
            dys[a.dtype] = dy.to(a.dtype)
        return ln._ln_bwd(a, g, dys[a.dtype], eps)

    def plain(a):
        return ln.layer_norm_backward_reference(a, g, dy.to(a.dtype), eps)

    def library(a):
        xl = a.detach().requires_grad_(True)
        gw = g.to(a.dtype).requires_grad_(True)
        bw = torch.zeros_like(gw, requires_grad=True)
        y = F.layer_norm(xl, (c,), gw, bw, eps)
        return _grad_call(y, (xl, gw, bw), dy.to(a.dtype))

    return kernel, plain, library


def ln_cases(dev, gen, sites, path):
    """The LayerNorm sites of a path: ``EVAL_LN``, ``TRAIN_LN`` or
    ``TEACHER_LN``; each also at ``LARGE_MEAN``."""
    recs = []
    for label, rows, c, eps, work in sites:
        x, large, g, bt = _ln_inputs(dev, gen, rows, c)
        calls = _ln_fwd_calls(g, bt, eps, c)
        item = torch.finfo(work).bits // 8
        rec = measure("fused_layer_norm", f"{path} {label} rows={rows} C={c} eps={eps}", x,
                      *calls, work, "layer_norm", 8 * rows * c, "fp32",
                      2 * rows * c * item + 2 * c * 4)
        recs.append(_ln_record(rec, "layer_norm", calls, x, large, c, work))
    return recs


def _bf16_values(t):
    """t rounded to bf16 and held in fp32: a cotangent both dtypes share."""
    return t.to(torch.bfloat16).float()


def _direct_bwd_inputs(dev, gen, swin=SwinConfig.base(), stages=range(4), b=TRAIN_B,
                       t=TRAIN_T):
    """The direct backward's inputs at the swin stages ``stages`` (of
    ``swin``'s widths) of the train step: B = 20 clips of T = 4 frames at
    224^2, window (4, 7, 7), N = 196, hd = 32 (the multiple-choice step: 8
    clips of 5 frames, window (5, 7, 7), N = 245); x3, do and bias drawn once
    a stage, for its unshifted and shifted block. Yields (stage, window, nH,
    x3, do, bias, mask or None)."""
    for stage in stages:
        hw, c, nh = 56 >> stage, swin.embed_dim << stage, swin.num_heads[stage]
        win, shift = get_window_size((t, hw, hw), (8, 7, 7), (4, 3, 3))
        n = win[0] * win[1] * win[2]
        hp = -(-hw // win[1]) * win[1]
        x3 = torch.randn(b, t, hp, hp, 3 * c, device=dev, generator=gen) * 0.5
        do = _bf16_values(torch.randn(b, t, hp, hp, c, device=dev, generator=gen))
        bias = torch.randn(nh, n, n, device=dev, generator=gen) * 0.02
        masks = [None]
        if any(shift):
            masks.append(torch.from_numpy(_shift_attn_mask((t, hp, hp), win, shift)).to(dev))
        for mask in masks:
            yield stage, win, nh, x3, do, bias, mask


def direct_bwd_cases(dev, gen, path="", swin=SwinConfig.base(), stages=range(4), b=TRAIN_B,
                     t=TRAIN_T):
    """The direct backward at the train step's swin stages
    (``_direct_bwd_inputs``): every stage of Swin-base, the violet swin's
    stages 2 and 3, or every stage of the multiple-choice step's Swin-base
    (b = 8 clips of t = 5 frames)."""
    recs = []
    for stage, win, nh, x3, do, bias, mask in _direct_bwd_inputs(dev, gen, swin, stages, b, t):
        b, t, hp, _, c3 = x3.shape
        c, n = c3 // 3, bias.shape[-1]
        hd, nw = c // nh, (hp // win[1]) * (hp // win[2])
        scale = hd ** -0.5

        def kernel(a):
            return wa._direct_bwd(a, bias, mask, do.to(a.dtype), win, nh, scale)

        def plain(a):
            return wa.direct_window_attention_backward_plain(a, bias, mask, do.to(a.dtype),
                                                             win, nh, scale)

        def library(a):
            q, k, v = (u.detach().requires_grad_(True)
                       for u in _direct_sdpa(a, win, b, nw, nh))
            m = _window_sdpa_mask(bias, mask, nw, a.dtype)
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=scale)
            dop = wa.window_partition(do.to(a.dtype), win).reshape(b, nw, n, nh, hd)
            return _grad_call(out, (q, k, v),
                              dop.transpose(2, 3).reshape(b, nw * nh, n, hd).contiguous())

        label = f"{path}stage{stage} x3=({b},{t},{hp},{hp},{3 * c}) nH={nh} " + (
            "shifted" if mask is not None else "unshifted")
        ops = 2.5 * 4 * b * nw * nh * n * n * hd
        nbytes = (2 * x3.numel() + do.numel()) * 2 + 2 * bias.numel() * 4 + (
            0 if mask is None else mask.numel() * 4)
        recs.append(measure("direct_window_attention_bwd", label, x3, kernel, plain,
                            library, torch.bfloat16, _window_bwd_kind(hd), ops,
                            "bf16_tensor", nbytes))
        recs[-1]["body"] = _bodies(wa._window_bwd_body, hd)
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
                  fwd_library, torch.bfloat16, _lane_fwd_kind(hd), ops, "bf16_tensor",
                  x3.numel() * 2 + p * l * d * 2 + p * l * 4)
    fwd.update(keep_fraction=frac, body=_bodies(wa._sa_body, hd))
    if abs(frac - (1 - P_ATTN)) > KEEP_SIGMAS * sigma:
        fwd["failures"].append(f"dropout keep fraction {frac} is not {1 - P_ATTN} "
                               f"+- {KEEP_SIGMAS} sigma ({sigma:.3g})")
    print(json.dumps({"dropout_keep_fraction": frac, "expected": 1 - P_ATTN,
                      "sigma": sigma}), flush=True)
    bwd = measure("lane_self_attention_bwd", label, x3, bwd_kernel, bwd_plain,
                  bwd_library, torch.bfloat16, "attention_bwd", 2.5 * ops, "bf16_tensor",
                  (2 * x3.numel() + do.numel()) * 2 + p * l * 4)
    bwd["body"] = _bodies(wa._sa_body, hd)
    return [fwd, bwd]


def _window_shapes():
    """(stage, windows of one clip, C, nH, mask or None, blocks of the shape)
    of a 2D Swin-base on TRAIN_T frames of 224^2: window (1, 7, 7), n = 49,
    hd = 32; blocks alternate unshifted and shifted, and stage 3 clamps to
    one unshifted 7 x 7 window. The mask is the per-frame shift mask over
    all TRAIN_T frames' windows, as BasicLayer builds it."""
    for stage, depth in enumerate(swin2d_config("base").depths):
        hw, c, nh = 56 >> stage, 128 << stage, 4 << stage
        win, shift = get_window_size((TRAIN_T, hw, hw), (1, 7, 7), (0, 3, 3))
        nw = TRAIN_T * (hw // 7) ** 2
        if any(shift):
            yield stage, nw, c, nh, None, (depth + 1) // 2
            yield stage, nw, c, nh, _shift_attn_mask((TRAIN_T, hw, hw), win, shift), depth // 2
        else:
            yield stage, nw, c, nh, None, depth


def _window_sdpa_mask(bias, mk, nw, dtype):
    """bias + mask as a (1, nW * nH, N, N) ``attn_mask`` that broadcasts
    over the clips, for SDPA on (clips, nW * nH, N, hd)."""
    nh, n, _ = bias.shape
    m = bias[None] if mk is None else bias[None] + mk[:, None]
    return m.expand(nw, nh, n, n).reshape(1, nw * nh, n, n).to(dtype)


def lane_window_cases(dev, gen):
    """The 2D swin's window attention (the frozen teacher of the 2d_feature
    step; the student of the swin2d step): 20 clips of 4 frames at 224^2,
    window (1, 7, 7) (n = 49, hd = 32: each frame's windows on their own),
    at every Swin-base stage, unshifted and shifted with the 4-frame mask
    (``_window_shapes``). SDPA, the yardstick, runs on (clips, nW * nH, 49,
    32), a clip's windows and heads on one axis, with the broadcast
    ``_window_sdpa_mask``. Each record carries its shape's launches in one
    step's 24 blocks (``launches_per_step``) and the body each dtype ran; its
    bf16 is held to the limits of that body (``_window_fwd_kind``)."""
    b, n, hd = TRAIN_B, 49, 32
    recs = []
    for stage, nw, c, nh, mk, blocks in _window_shapes():
        x3 = torch.randn(b * nw, n, 3 * c, device=dev, generator=gen) * 0.5
        bias = torch.randn(nh, n, n, device=dev, generator=gen) * 0.02
        mk = None if mk is None else torch.from_numpy(mk).to(dev)
        n_w = nw if mk is not None else 1
        scale = hd ** -0.5

        def kernel(a, bias=bias, mk=mk, n_w=n_w, nh=nh):
            return wa.lane_window_attention(a, bias, mk, n_w, nh, scale)

        def plain(a, bias=bias, mk=mk, n_w=n_w, nh=nh):
            return wa.lane_window_attention_reference(a, bias, mk, n_w, nh, scale)

        def library(a, bias=bias, mk=mk, nh=nh, nw=nw):
            qkv = a.reshape(b, nw, n, 3, nh, hd).permute(3, 0, 1, 4, 2, 5)
            q, k, v = qkv.reshape(3, b, nw * nh, n, hd).unbind(0)
            m = _window_sdpa_mask(bias, mk, nw, a.dtype)
            return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=scale)

        label = f"2d swin stage{stage} x3=({b * nw},{n},{3 * c}) nH={nh} " + (
            "unshifted" if mk is None else f"shifted nW={n_w}")
        ops = 4 * b * nw * nh * n * n * hd
        nbytes = x3.numel() * 2 + b * nw * n * c * 2 + bias.numel() * 4 + (
            0 if mk is None else mk.numel() * 4)
        recs.append(measure("lane_window_attention", label, x3, kernel, plain, library,
                            torch.bfloat16, _window_fwd_kind(hd, n), ops, "bf16_tensor",
                            nbytes))
        recs[-1].update(launches_per_step=blocks, body=_bodies(wa._window_fwd_body, hd, n))
    return recs


def _window_bwd_inputs(dev, gen):
    """The lane window backward's inputs at ``_window_shapes``: x3, do and
    bias drawn once a shape. Yields (stage, nW of one clip, nH, x3, do,
    bias, mask or None, blocks of the shape)."""
    b, n = TRAIN_B, 49
    for stage, nw, c, nh, mk, blocks in _window_shapes():
        x3 = torch.randn(b * nw, n, 3 * c, device=dev, generator=gen) * 0.5
        do = _bf16_values(torch.randn(b * nw, n, c, device=dev, generator=gen))
        bias = torch.randn(nh, n, n, device=dev, generator=gen) * 0.02
        yield stage, nw, nh, x3, do, bias, None if mk is None else torch.from_numpy(mk).to(dev), \
            blocks


def lane_window_bwd_cases(dev, gen):
    """The trained 2D swin's window attention backward in the swin2d step:
    the shapes of ``lane_window_cases`` (``_window_bwd_inputs``). SDPA's
    backward, the yardstick, runs on the layout and broadcast mask of the
    forward's yardstick."""
    recs = []
    for stage, nw, nh, x3, do, bias, mk, blocks in _window_bwd_inputs(dev, gen):
        b, n, hd = TRAIN_B, 49, 32
        c = x3.shape[-1] // 3
        n_w = nw if mk is not None else 1
        scale = hd ** -0.5

        def kernel(a):
            return wa._lane_window_bwd(a, bias, mk, do.to(a.dtype), n_w, nh, scale)

        def plain(a):
            return wa.lane_window_attention_backward_plain(a, bias, mk, do.to(a.dtype), n_w,
                                                           nh, scale)

        def library(a):
            qkv = a.reshape(b, nw, n, 3, nh, hd).permute(3, 0, 1, 4, 2, 5)
            q, k, v = (u.detach().requires_grad_(True) for u in
                       qkv.reshape(3, b, nw * nh, n, hd).contiguous().unbind(0))
            m = _window_sdpa_mask(bias, mk, nw, a.dtype)
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=scale)
            dop = do.to(a.dtype).reshape(b, nw, n, nh, hd).permute(0, 1, 3, 2, 4)
            return _grad_call(out, (q, k, v), dop.reshape(b, nw * nh, n, hd).contiguous())

        label = f"2d swin stage{stage} x3=({b * nw},{n},{3 * c}) nH={nh} " + (
            "unshifted" if mk is None else f"shifted nW={n_w}")
        ops = 2.5 * 4 * b * nw * nh * n * n * hd
        nbytes = (2 * x3.numel() + do.numel()) * 2 + 2 * bias.numel() * 4 + (
            0 if mk is None else mk.numel() * 4)
        recs.append(measure("lane_window_attention_bwd", label, x3, kernel, plain, library,
                            torch.bfloat16, _window_bwd_kind(hd), ops, "bf16_tensor", nbytes))
        recs[-1].update(launches_per_step=blocks, body=_bodies(wa._window_bwd_body, hd))
    return recs


def _packed_shapes():
    """(label, windows of one clip, C, nH, N, mask or None, launches in one
    violet step) of ``packed_window_attention``: stages 0 and 1 of the C =
    96 Video Swin (``swin_violet.py``) on TRAIN_T frames of 224^2, window
    clamped to (4, 7, 7) (N = 196, hd = 32), each stage one unshifted and one
    shifted block; and stage 0 of the 2D Swin-tiny on the same clips, window
    (1, 7, 7) (N = 49) with the 4-frame mask, on no path of this script (0
    launches)."""
    violet = SwinConfig.violet()
    for stage in (0, 1):
        hw, c, nh = 56 >> stage, violet.embed_dim << stage, violet.num_heads[stage]
        win, shift = get_window_size((TRAIN_T, hw, hw), violet.window_size, (4, 3, 3))
        nw, n = (hw // 7) ** 2, win[0] * win[1] * win[2]
        yield f"violet stage{stage}", nw, c, nh, n, None, 1
        yield f"violet stage{stage}", nw, c, nh, n, _shift_attn_mask((TRAIN_T, hw, hw), win,
                                                                     shift), 1
    tiny = swin2d_config("tiny")
    c, nh = tiny.embed_dim, tiny.num_heads[0]
    win, shift = get_window_size((TRAIN_T, 56, 56), (1, 7, 7), (0, 3, 3))
    for mk in (None, _shift_attn_mask((TRAIN_T, 56, 56), win, shift)):
        yield "2d swin-tiny stage0", TRAIN_T * 64, c, nh, 49, mk, 0


def _packed_sdpa(a, b, nw, nh, n, hd):
    """q, k, v of SDPA on (clips, nW * nH, N, hd) from packed (B_, 3nH, N,
    hd): a clip's windows and heads on one axis."""
    return a.reshape(b, nw, 3, nh, n, hd).transpose(1, 2).reshape(b, 3, nw * nh, n, hd).unbind(1)


def packed_cases(dev, gen):
    """``packed_window_attention`` forward and backward at ``_packed_shapes``,
    and ``fused_window_attention`` (q, k, v as three arrays: the same kernel
    on three base pointers) forward and backward at the violet stage-0
    shifted shape. SDPA, the yardstick, runs on (clips, nW * nH, N, hd) with
    the broadcast ``_window_sdpa_mask``, its backward through autograd. Each
    record carries its shape's launches in one violet step
    (``launches_per_step``); the 2D Swin-tiny records are marked
    ``off_path``."""
    b, hd = TRAIN_B, 32
    recs = []
    for label, nw, c, nh, n, mk, blocks in _packed_shapes():
        b_ = b * nw
        qkv = torch.randn(b_, 3 * nh, n, hd, device=dev, generator=gen) * 0.5
        do = _bf16_values(torch.randn(b_, nh, n, hd, device=dev, generator=gen))
        bias = torch.randn(nh, n, n, device=dev, generator=gen) * 0.02
        mk = None if mk is None else torch.from_numpy(mk).to(dev)
        n_w = nw if mk is not None else 1
        scale = hd ** -0.5
        label = f"{label} qkv=({b_},{3 * nh},{n},{hd}) " + (
            "unshifted" if mk is None else f"shifted nW={n_w}")

        def fwd_kernel(a, bias=bias, mk=mk, n_w=n_w, nh=nh):
            return wa.packed_window_attention(a, bias, mk, n_w, nh, scale)

        def fwd_plain(a, bias=bias, mk=mk, n_w=n_w, nh=nh):
            return wa.packed_window_attention_plain(a, bias, mk, n_w, nh, scale)

        def fwd_library(a, bias=bias, mk=mk, nh=nh, nw=nw, n=n):
            q, k, v = _packed_sdpa(a, b, nw, nh, n, hd)
            m = _window_sdpa_mask(bias, mk, nw, a.dtype)
            return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=scale)

        def bwd_kernel(a, bias=bias, mk=mk, n_w=n_w, nh=nh, do=do):
            return wa._packed_bwd(a, bias, mk, do.to(a.dtype), n_w, nh, scale)

        def bwd_plain(a, bias=bias, mk=mk, n_w=n_w, nh=nh, do=do):
            return wa.packed_window_attention_backward_plain(a, bias, mk, do.to(a.dtype), n_w,
                                                             nh, scale)

        def bwd_library(a, bias=bias, mk=mk, nh=nh, nw=nw, n=n, do=do):
            q, k, v = (u.detach().contiguous().requires_grad_(True)
                       for u in _packed_sdpa(a, b, nw, nh, n, hd))
            m = _window_sdpa_mask(bias, mk, nw, a.dtype)
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=scale)
            dop = do.to(a.dtype).reshape(b, nw * nh, n, hd)
            return _grad_call(out, (q, k, v), dop)

        ops = 4 * b_ * nh * n * n * hd
        extra = bias.numel() * 4 + (0 if mk is None else mk.numel() * 4)
        fwd = measure("packed_window_attention", label, qkv, fwd_kernel, fwd_plain,
                      fwd_library, torch.bfloat16, _window_fwd_kind(hd, n), ops,
                      "bf16_tensor", (qkv.numel() + do.numel()) * 2 + extra)
        fwd["body"] = _bodies(wa._window_fwd_body, hd, n)
        bwd = measure("packed_window_attention_bwd", label, qkv, bwd_kernel, bwd_plain,
                      bwd_library, torch.bfloat16, _window_bwd_kind(hd), 2.5 * ops,
                      "bf16_tensor", (2 * qkv.numel() + do.numel()) * 2 + extra
                      + bias.numel() * 4)
        bwd["body"] = _bodies(wa._window_bwd_body, hd)
        for rec in (fwd, bwd):
            rec["launches_per_step"] = blocks
            if not blocks:
                rec["off_path"] = True
        recs += [fwd, bwd]
        if label.startswith("violet stage0") and mk is not None:
            recs += fused_cases(qkv, do, bias, mk, nw, nh, label)
    return recs


def fused_cases(qkv, do, bias, mk, nw, nh, label):
    """``fused_window_attention`` and its backward on q, k, v (B_, nH, N,
    hd) held apart (a (3, B_, nH, N, hd) stack unbound) from ``qkv``'s
    values."""
    b_, _, n, hd = qkv.shape
    stack = qkv.reshape(b_, 3, nh, n, hd).transpose(0, 1).contiguous()
    scale = hd ** -0.5

    def fwd_kernel(a):
        return wa.fused_window_attention(*a.unbind(0), bias, mk, nw, scale)

    def fwd_plain(a):
        return wa.fused_window_attention_plain(*a.unbind(0), bias, mk, nw, scale)

    def fwd_library(a):
        q, k, v = (u.reshape(b_ // nw, nw * nh, n, hd) for u in a.unbind(0))
        m = _window_sdpa_mask(bias, mk, nw, a.dtype)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=scale)

    def bwd_kernel(a):
        return wa._fused_bwd(*a.unbind(0), bias, mk, do.to(a.dtype), nw, scale)

    def bwd_plain(a):
        return wa.fused_window_attention_backward_plain(*a.unbind(0), bias, mk, do.to(a.dtype),
                                                        nw, scale)

    def bwd_library(a):
        q, k, v = (u.reshape(b_ // nw, nw * nh, n, hd).detach().requires_grad_(True)
                   for u in a.unbind(0))
        m = _window_sdpa_mask(bias, mk, nw, a.dtype)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=scale)
        return _grad_call(out, (q, k, v), do.to(a.dtype).reshape(b_ // nw, nw * nh, n, hd))

    ops = 4 * b_ * nh * n * n * hd
    extra = bias.numel() * 4 + mk.numel() * 4
    label = label.replace("qkv=", "q,k,v=3x").replace(f",{3 * nh},", f",{nh},")
    fwd = measure("fused_window_attention", label, stack, fwd_kernel, fwd_plain, fwd_library,
                  torch.bfloat16, _window_fwd_kind(hd, n), ops, "bf16_tensor",
                  (stack.numel() + do.numel()) * 2 + extra)
    fwd["body"] = _bodies(wa._window_fwd_body, hd, n)
    bwd = measure("fused_window_attention_bwd", label, stack, bwd_kernel, bwd_plain,
                  bwd_library, torch.bfloat16, _window_bwd_kind(hd, split=True), 2.5 * ops,
                  "bf16_tensor", (2 * stack.numel() + do.numel()) * 2 + extra
                  + bias.numel() * 4)
    bwd["body"] = _bodies(wa._window_bwd_body, hd)
    return [fwd, bwd]


def clip_lane_case(dev, gen):
    """Row 5 at the CLIP teacher's shape in the 2d_clip step: 80 frames of
    L = 50 tokens (the class token and 7 x 7 patches), ViT-B/32's 12 heads
    of 64, p = 0, the zero mask ``CLIPAttention`` passes (a (1, 1, L) row
    expanded). SDPA without a mask (the same function) is the yardstick."""
    p, l, d, nh = TRAIN_B * TRAIN_T, 50, 768, 12
    x3 = torch.randn(p, l, 3 * d, device=dev, generator=gen) * 0.5
    mask = torch.zeros(1, 1, l, device=dev).expand(p, l, l)
    scale = (d // nh) ** -0.5

    def kernel(a):
        return wa.lane_self_attention(a, mask, nh, scale)

    def plain(a):
        return wa.lane_self_attention_plain(a, mask, nh, scale)

    def library(a):
        q, k, v = a.reshape(p, l, 3, nh, d // nh).permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        return lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)

    ops = 4 * p * nh * l * l * (d // nh)
    nbytes = x3.numel() * 2 + p * l * d * 2 + _span_bytes(mask)
    rec = measure("lane_self_attention", f"2d_clip teacher x3=({p},{l},{3 * d}) nH={nh}", x3,
                  kernel, plain, library, torch.bfloat16, _lane_fwd_kind(d // nh), ops,
                  "bf16_tensor", nbytes)
    rec["body"] = _bodies(wa._sa_body, d // nh)
    return [rec]


def _shift_like_mask(dev, gen, nw, n):
    """(nW, N, N) of 0 or -100 with the structure of a swin shift mask: the
    tokens of each window in up to 4 seeded regions, a pair of tokens in two
    regions masked."""
    region = torch.randint(0, 4, (nw, n), device=dev, generator=gen)
    return torch.where(region[:, :, None] != region[:, None, :], -100.0, 0.0)


def _lane_attention_record(label, x3, bias, mask, nh):
    """Row 12 (``lane_attention``) on (B_, N, 3C) ``x3`` against its plain
    version and SDPA (4D: (B_ / nW, nW * nH, N, hd) with the broadcast
    ``_window_sdpa_mask``), and row 7 (``lane_window_attention``, the scale
    on q) timed on the same bf16 x3, bias and mask (``lane_window_ms``). The
    bf16 limits are those of the body bf16 ran (``_window_fwd_kind``), named
    in the record's ``body``."""
    b_, n, c3 = x3.shape
    c = c3 // 3
    hd, nw = c // nh, mask.shape[0]
    scale = hd ** -0.5

    def kernel(a):
        return wa.lane_attention(a, bias, mask, nh, scale)

    def plain(a):
        return wa.lane_attention_reference(a, bias, mask, nh, scale)

    def library(a):
        qkv = a.reshape(b_ // nw, nw, n, 3, nh, hd).permute(3, 0, 1, 4, 2, 5)
        q, k, v = qkv.reshape(3, b_ // nw, nw * nh, n, hd).contiguous().unbind(0)
        m = _window_sdpa_mask(bias, mask, nw, a.dtype)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=scale)

    ops = 4 * b_ * n * n * c
    nbytes = x3.numel() * 2 + b_ * n * c * 2 + bias.numel() * 4 + mask.numel() * 4
    rec = measure("lane_attention", label, x3, kernel, plain, library, torch.bfloat16,
                  _window_fwd_kind(hd, n), ops, "bf16_tensor", nbytes)
    rec["body"] = _bodies(wa._window_fwd_body, hd, n)
    a16 = x3.to(torch.bfloat16)
    rec["lane_window_ms"] = time_ms(
        lambda: wa.lane_window_attention(a16, bias, mask, nw, nh, scale))
    return rec


def lane_attention_cases(dev, gen):
    """Row 12, the lanebench tool's kernel, at the tool's three Swin-base
    stage shapes (``lanebench.SHAPES``: N = 196, hd = 32) in bf16, with the
    tool's zero mask (its path: the kernels line sums these) and a seeded
    shift-like mask (``_shift_like_mask``, marked ``off_path``); each record
    with row 7's time on the same inputs (``_lane_attention_record``)."""
    recs = []
    for stage, sh in lanebench.SHAPES.items():
        b_, n, c, nh, nw = (sh[k] for k in ("b_", "n", "c", "nh", "nw"))
        x3 = torch.randn(b_, n, 3 * c, device=dev, generator=gen) * 0.5
        bias = torch.randn(nh, n, n, device=dev, generator=gen) * 0.1
        masks = {"zero mask": torch.zeros(nw, n, n, device=dev),
                 "shift-like mask": _shift_like_mask(dev, gen, nw, n)}
        for name, mask in masks.items():
            rec = _lane_attention_record(f"lanebench stage{stage} x3=({b_},{n},{3 * c}) "
                                         f"nH={nh} nW={nw} {name}", x3, bias, mask, nh)
            rec["off_path"] = name != "zero mask"
            recs.append(rec)
    return recs


def c128_cases(dev, gen):
    """What the C % 128 rule costs (``off_path``): at the C = 96 Video
    Swin's stages 0 and 1 of the violet step (20 clips of 4 frames, window
    (4, 7, 7): N = 196, hd = 32, the shifted block), row 12 and row 7 on the
    partitioned windows (B_, N, 3C) against the route ``WindowAttention3D``
    takes there, ``_to_packed`` + row 9 + ``_from_packed`` on the (B, D, H,
    W, 3C) map of the same values (``packed_route_ms``; the largest
    difference of its output from row 7's, the same function with the same
    roundings, beside it)."""
    violet = SwinConfig.violet()
    recs = []
    for stage in (0, 1):
        hw, c, nh = 56 >> stage, violet.embed_dim << stage, violet.num_heads[stage]
        win, shift = get_window_size((TRAIN_T, hw, hw), violet.window_size, (4, 3, 3))
        n, nw = win[0] * win[1] * win[2], (hw // win[1]) * (hw // win[2])
        scale = (c // nh) ** -0.5
        x5 = torch.randn(TRAIN_B, TRAIN_T, hw, hw, 3 * c, device=dev, generator=gen) * 0.5
        xw = wa.window_partition(x5, win).contiguous()
        bias = torch.randn(nh, n, n, device=dev, generator=gen) * 0.02
        mask = torch.from_numpy(_shift_attn_mask((TRAIN_T, hw, hw), win, shift)).to(dev)
        rec = _lane_attention_record(
            f"C % 128 cost: violet stage{stage} x3=({xw.shape[0]},{n},{3 * c}) nH={nh} "
            f"shifted nW={nw}", xw, bias, mask, nh)
        x16 = x5.to(torch.bfloat16)

        def packed_route(x16=x16, win=win, nh=nh, bias=bias, mask=mask, nw=nw, scale=scale,
                         hw=hw):
            out = wa.packed_window_attention(_to_packed(x16, win, nh), bias, mask, nw, nh,
                                             scale)
            return _from_packed(out, win, TRAIN_B, TRAIN_T, hw, hw)

        lane_window = wa.lane_window_attention(xw.to(torch.bfloat16), bias, mask, nw, nh, scale)
        rec.update(packed_route_ms=time_ms(packed_route), off_path=True,
                   packed_route_vs_lane_window_max_abs=(
                       wa.window_partition(packed_route(), win) - lane_window).abs().max()
                   .float().item())
        print(json.dumps({"c128_cost": {k: rec[k] for k in (
            "shape", "ms", "lane_window_ms", "packed_route_ms",
            "packed_route_vs_lane_window_max_abs")}}), flush=True)
        recs.append(rec)
        del x5, xw, x16, lane_window
    return recs


# Faults planted in copies of csrc/ for phase 3 (file, correct texts,
# planted texts), each a rounding point or term of the JAX kernels that a
# tensor-core body could move (its roundings of p and ds are structural: an
# mma operand is bf16). Row 11's body, forward: the normalisation moved after
# P.V, so the unnormalised p is rounded; row 5 runs the same forward and must
# fail too. Backward: dk from q as stored, the scale applied to the fp32
# product, so q * scale is not rounded before dk (a fault only where the scale
# is inexact in bf16: hd 32, not 64, whose scale 0.125 is a power of two).
# The window backward's body: ds rounded to bf16 before it enters dbias (the
# JAX kernels sum the fp32 ds). Row 6 on row 11's backward: the keep mask
# dropped from dp in the rows kernel (D, ds and dq of every dropped score).
# The window forward's body (rows 3, 7, 9, 10, 12): e = exp(s - max) rounded
# to bf16 before it is normalised (and p rounded again). The first two are planted in
# one copy, the last three in another (the keep-mask fault would also fail
# row 11's backward check, whose own fault it must not hide; each of the
# others moves only its own kernels).
PLANTED_TILED = {
    "forward p rounded before normalising": (
        "self_attention_mma.cuh",
        ("div_rn(expf(__fsub_rn(sc[nt][e], mx[e >> 1])), sum[e >> 1], rcp[e >> 1]);",
         "pack(o[dt][2 * r], o[dt][2 * r + 1]);"),
        ("expf(__fsub_rn(sc[nt][e], mx[e >> 1]));",
         "pack(o[dt][2 * r] / sum[r], o[dt][2 * r + 1] / sum[r]);")),
    "backward q * scale not rounded before dk": (
        "self_attention_mma.cuh",
        ("product_nn<HD, G::kColDTiles>(ak, sa, qs,", "pack(ak[dt][2 * r], ak[dt][2 * r + 1])"),
        ("product_nn<HD, G::kColDTiles>(ak, sa, qb,",
         "pack(ak[dt][2 * r] * scale_t, ak[dt][2 * r + 1] * scale_t)")),
    "window backward ds rounded before dbias": (
        "attention_bwd_mma.cuh",
        "part[size_t(rows[r]) * n + j] = first_window ? ds : __fadd_rn(old[nt][e], ds);",
        "ds = __bfloat162float(__float2bfloat16(ds));\n"
        "part[size_t(rows[r]) * n + j] = first_window ? ds : __fadd_rn(old[nt][e], ds);"),
    "lane backward keep mask dropped from dp in the rows kernel": (
        "self_attention_mma.cuh",
        "const float d = drop.on ? drop_scale(keep[r][e & 1], dp[nt][e], drop.inv_keep)\n"
        "                                  : dp[nt][e];",
        "const float d = dp[nt][e];"),
    "window forward e rounded before normalising": (
        "attention_fwd_mma.cuh",
        "const float p = sa_mma::div_rn(sv[u], sum, rcp);",
        "const float p = __fdiv_rn(__bfloat162float(__float2bfloat16(sv[u])), sum);"),
}
# the faults of each planted copy of csrc/
PLANTED_COPIES = (tuple(PLANTED_TILED)[:2], tuple(PLANTED_TILED)[2:])
# Faults planted in the LayerNorm's vectorized body (csrc/layer_norm.cu),
# each a term of the JAX numerics: the one-pass variance E[x^2] - mean^2
# (held at the LARGE_MEAN rows), the m2 term dropped from dx, and the first
# partial row left out of dgamma and dbeta (the fixed-order sum of the
# partials, which both bodies share). Each is planted in a copy of its own
# that holds layer_norm.cu and its header alone, and builds in seconds.
PLANTED_LN = {
    "one-pass variance": (
        "layer_norm.cu",
        ("const float d = Vec::get(xv[v], e) - mean;", "rsqrtf(group_sum<G>(q) / C + eps)"),
        ("const float d = Vec::get(xv[v], e);",
         "rsqrtf(group_sum<G>(q) / C - mean * mean + eps)")),
    "m2 dropped from dx": (
        "layer_norm.cu", "o[e] = rstd * (gy * ga[u] - m1 - xhat * m2);",
        "o[e] = rstd * (gy * ga[u] - m1);"),
    "first partial left out of dgamma and dbeta": (
        "layer_norm.cu", "for (int b = b0; b < b1; ++b) s += part[size_t(b) * c2 + k];",
        "for (int b = b0 + (warp == 0); b < b1; ++b) s += part[size_t(b) * c2 + k];"),
}
LN_SOURCES = ("common.cuh", "layer_norm.cu")


def plant(src: Path, name: str, good, bad) -> None:
    """Replace, in the csrc copy ``src``, each text of ``good`` (one string
    or a tuple) in file ``name`` with the same item of ``bad``; each must
    occur there exactly once."""
    text = (src / name).read_text()
    for g, b in zip(_tuple(good), _tuple(bad)):
        require(text.count(g) == 1, f"planted fault: {g!r} is not in {name} once")
        text = text.replace(g, b)
    (src / name).write_text(text)


def _span_bytes(t):
    """The bytes of storage that a view spans: a broadcast axis (stride 0),
    such as the padding mask's query axis, reads no more."""
    return (1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))) * t.element_size()


def _padding_mask(dev, gen, b, n, text, shortest):
    """The (B, N, N) view of a (B, 1, N) padding bias that BertEncoder
    passes: the last ``text`` keys are a caption of ``shortest`` to ``text``
    tokens, zero-padded."""
    keep = torch.ones(b, n, device=dev)
    lens = torch.randint(shortest, text + 1, (b,), device=dev, generator=gen)
    keep[:, n - text:] = (torch.arange(text, device=dev)[None] < lens[:, None]).float()
    return ((1.0 - keep) * torch.finfo(torch.float32).min)[:, None, :].expand(b, n, n)


def _sa_calls(mask, nh, scale, p_drop, seed, do):
    """The tiled kernel's forward and backward on qkv, its plain versions,
    and their SDPA yardsticks (``attn_mask`` = mask[:, None]); the backward
    kernel runs from the forward's stats, computed once per dtype outside
    the timed calls."""
    stats = {}

    def fwd(a):
        return wa._packed_sa_fwd(a, mask, nh, scale, p_drop, seed)[0]

    def bwd(a):
        if a.dtype not in stats:
            stats[a.dtype] = wa._packed_sa_fwd(a, mask, nh, scale, p_drop, seed)[1]
        return wa._packed_sa_bwd(a, mask, do.to(a.dtype), stats[a.dtype], nh, scale, p_drop,
                                 seed)

    def fwd_plain(a):
        return wa.packed_self_attention_plain(a, mask, nh, scale, p_drop, seed)

    def bwd_plain(a):
        return wa.packed_self_attention_backward_plain(a, mask, do.to(a.dtype), nh, scale,
                                                       p_drop, seed)

    def sdpa(a, grad):
        q, k, v = (u.detach().contiguous().requires_grad_(grad) for u in a.chunk(3, dim=1))
        m = mask[:, None].to(a.dtype)
        return q, k, v, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                                               dropout_p=p_drop, scale=scale)

    def fwd_library(a):
        return sdpa(a, False)[-1]

    def bwd_library(a):
        q, k, v, call = sdpa(a, True)
        return _grad_call(call(), (q, k, v), do.to(a.dtype))

    return (fwd, fwd_plain, fwd_library), (bwd, bwd_plain, bwd_library)


def tiled_sa_cases(dev, gen):
    """Row 11, the tiled self-attention (``packed_self_attention`` and its
    backward; ``fused_self_attention``, the same kernel on q, k, v apart):
    (a) the multiple-choice fusion, 40 rows of 350 tokens (250 video + a
    question and option of 8 to 100 tokens), 12 heads of 64: forward at p = 0
    (the eval) and p = 0.1 (the fine-tune step), backward at p = 0.1, and the
    dropout keep fraction; (b) DPT-Large at 384^2, 8 images of 577 tokens, 16
    heads, no mask, forward in fp32 (which row 5's shared memory cannot hold)
    and bf16, backward in bf16; (c) the split entry at (a)'s shape with
    dropout; (d) N = 129, one key of the last tile. (b)-(d) are on no path of
    this script (``off_path``). SDPA with ``attn_mask`` = mask[:, None] (and
    ``dropout_p``) is the yardstick."""
    recs = []
    shapes = (("mc fusion", QAMC_B * QAMC_O, 12, QAMC_L, 100, (0.0, P_ATTN)),
              ("dpt 384", 8, 16, 577, 0, (0.0,)),
              ("ragged", 16, 12, 129, 32, (P_ATTN,)))
    for label, b, nh, n, text, rates in shapes:
        hd = 64
        qkv = torch.randn(b, 3 * nh, n, hd, device=dev, generator=gen) * 0.5
        do = _bf16_values(torch.randn(b, nh, n, hd, device=dev, generator=gen))
        mask = (_padding_mask(dev, gen, b, n, text, 8) if text
                else torch.zeros(b, n, n, device=dev))
        scale = hd ** -0.5
        seed = torch.tensor([20261016, 11], dtype=torch.int32, device=dev)
        ops = 4 * b * nh * n * n * hd
        mask_bytes = _span_bytes(mask)
        on_path = label == "mc fusion"
        mine = []
        for p_drop in rates:
            (fwd, *fwd_rest), (bwd, *bwd_rest) = _sa_calls(mask, nh, scale, p_drop,
                                                           seed if p_drop else None, do)
            name = f"{label} qkv=({b},{3 * nh},{n},{hd}) p_drop={p_drop}"
            works = (torch.float32, torch.bfloat16) if label == "dpt 384" else (torch.bfloat16,)
            for work in works:
                item = torch.finfo(work).bits // 8
                mine.append(measure(
                    "packed_self_attention", f"{name} {str(work)[6:]}", qkv, fwd, *fwd_rest,
                    work, "sa", ops, "bf16_tensor" if item == 2 else "fp32",
                    (qkv.numel() + do.numel()) * item + mask_bytes))
            if on_path and p_drop:
                keep = wa.dropout_keep(seed, (b, nh, n, n), p_drop)
                frac = keep.float().mean().item()
                sigma = (p_drop * (1 - p_drop) / keep.numel()) ** 0.5
                del keep
                mine[-1]["keep_fraction"] = frac
                if abs(frac - (1 - p_drop)) > KEEP_SIGMAS * sigma:
                    mine[-1]["failures"].append(f"dropout keep fraction {frac} is not "
                                                f"{1 - p_drop} +- {KEEP_SIGMAS} sigma")
            if p_drop or not on_path:
                mine.append(measure("packed_self_attention_bwd", name, qkv, bwd, *bwd_rest,
                                    torch.bfloat16, "sa_bwd", 2.5 * ops, "bf16_tensor",
                                    (2 * qkv.numel() + do.numel()) * 2 + mask_bytes))
            if on_path and p_drop:
                mine += split_sa_cases(qkv, do, mask, nh, p_drop, seed, name)
        for rec in mine:
            rec.setdefault("off_path", not on_path)
            dtype = getattr(torch, rec["dtype"])
            rec["body"] = _bodies(wa._sa_body, hd)
            rec["smem_bytes"] = _build.library().emvm_tiled_self_attention_smem_bytes(
                _build.dtype_code(dtype), hd, int(rec["kernel"].endswith("_bwd")))
        recs += mine
    recs[0]["failures"] += planted_tiled_check(dev, gen)
    return recs


def split_sa_cases(qkv, do, mask, nh, p_drop, seed, label):
    """``fused_self_attention`` and its backward on q, k, v (B, nH, N, hd)
    held apart (a (3, B, nH, N, hd) stack unbound) from ``qkv``'s values."""
    b, _, n, hd = qkv.shape
    stack = qkv.reshape(b, 3, nh, n, hd).transpose(0, 1).contiguous()
    scale = hd ** -0.5
    stats = {}

    def fwd(a):
        return wa._fused_sa_fwd(*a.unbind(0), mask, scale, p_drop, seed)[0]

    def bwd(a):
        if a.dtype not in stats:
            stats[a.dtype] = wa._fused_sa_fwd(*a.unbind(0), mask, scale, p_drop, seed)[1]
        return wa._fused_sa_bwd(*a.unbind(0), mask, do.to(a.dtype), stats[a.dtype], scale,
                                p_drop, seed)

    def sdpa(a, grad):
        q, k, v = (u.detach().requires_grad_(grad) for u in a.unbind(0))
        m = mask[:, None].to(a.dtype)
        return q, k, v, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                                               dropout_p=p_drop, scale=scale)

    def bwd_library(a):
        q, k, v, call = sdpa(a, True)
        return _grad_call(call(), (q, k, v), do.to(a.dtype))

    ops = 4 * b * nh * n * n * hd
    label = label.replace("qkv=", "q,k,v=3x").replace(f",{3 * nh},", f",{nh},")
    fwd_rec = measure("fused_self_attention", label, stack, fwd,
                      lambda a: wa.fused_self_attention_plain(*a.unbind(0), mask, scale, p_drop,
                                                              seed),
                      lambda a: sdpa(a, False)[-1], torch.bfloat16, "sa", ops,
                      "bf16_tensor", (stack.numel() + do.numel()) * 2 + _span_bytes(mask))
    bwd_rec = measure("fused_self_attention_bwd", label, stack, bwd,
                      lambda a: wa.fused_self_attention_backward_plain(
                          *a.unbind(0), mask, do.to(a.dtype), scale, p_drop, seed),
                      bwd_library, torch.bfloat16, "sa_bwd_qkv", 2.5 * ops, "bf16_tensor",
                      (2 * stack.numel() + do.numel()) * 2 + _span_bytes(mask))
    for rec in (fwd_rec, bwd_rec):
        rec["off_path"] = True
    return [fwd_rec, bwd_rec]


def _planted_library(tag, faults):
    """Build a copy of csrc/ with the ``PLANTED_TILED`` faults named in
    ``faults``; returns the loaded library."""
    src = _build.BUILD_DIR / f"planted_csrc_{tag}"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    for fault in faults:
        plant(src, *PLANTED_TILED[fault])
    return _build.load(_build.build(csrc=src))


def planted_tiled_check(dev, gen):
    """Build the ``PLANTED_COPIES`` of csrc/ (at once) and hold each fault's
    kernels to the bf16 limits, each of which must fail: row 11's forward at
    the multiple-choice shape in small (8 rows of 350, 12 heads of 64, p =
    0.1) and row 5 at the fusion's (8 rows of 232, p = 0.1); row 11's
    backward at the multiple-choice rows with 24 heads of 32 (where q * scale
    rounds); the direct window backward at a Video Swin stage-2 shape in
    small (2 clips, N = 196, 16 heads of 32, shifted); row 6 at the fusion's
    shape in small (8 rows of 232, 12 heads of 64, p = 0.1); the direct
    window forward at the eval's stage 2 in small (2 clips, N = 245, 16 heads
    of 32, shifted), the packed forward at the violet stage 0 (2 clips,
    N = 196, 3 heads, shifted), the lane window forward (row 7) at the 2D
    swin's stage 2 in small (2 clips of 4 frames: 32 windows of 49 tokens,
    16 heads of 32, the 4-frame shift mask) and ``lane_attention`` (row 12)
    at the lanebench tool's stage 2 in small (16 windows of 196 tokens, 16
    heads of 32, a shift-like mask over 4 slots). Returns the faults that
    passed a check."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(PLANTED_COPIES)) as pool:
        row11, rest = pool.map(_planted_library, ("row11", "rest"), PLANTED_COPIES)
    build_s = time.perf_counter() - t0
    b, n = 8, QAMC_L
    mask = _padding_mask(dev, gen, b, n, 100, 8)
    seed = torch.tensor([78, 2], dtype=torch.int32, device=dev)
    cases = []
    for nh, hd in ((12, 64), (24, 32)):
        qkv = torch.randn(b, 3 * nh, n, hd, device=dev, generator=gen) * 0.5
        do = _bf16_values(torch.randn(b, nh, n, hd, device=dev, generator=gen))
        cases.append((qkv, _sa_calls(mask, nh, hd ** -0.5, P_ATTN, seed, do)))
    (q64, ((fwd, fwd_plain, _), _)), (q32, (_, (bwd, bwd_plain, _))) = cases
    win, nh, c, hp = (4, 7, 7), 16, 512, 14
    x3 = torch.randn(2, 4, hp, hp, 3 * c, device=dev, generator=gen) * 0.5
    dw = _bf16_values(torch.randn(2, 4, hp, hp, c, device=dev, generator=gen))
    bias = torch.randn(nh, 196, 196, device=dev, generator=gen) * 0.02
    wmask = torch.from_numpy(_shift_attn_mask((4, hp, hp), win, (0, 3, 3))).to(dev)
    lb, ll = 8, TRAIN_L
    xl = torch.randn(lb, ll, 3 * 768, device=dev, generator=gen) * 0.5
    dl = _bf16_values(torch.randn(lb, ll, 768, device=dev, generator=gen))
    lmask = _padding_mask(dev, gen, lb, ll, 32, 6)
    lseed = torch.tensor([77, 1], dtype=torch.int32, device=dev)
    window = (lambda a: wa._direct_bwd(a, bias, wmask, dw.to(a.dtype), win, nh, 32 ** -0.5),
              lambda a: wa.direct_window_attention_backward_plain(
                  a, bias, wmask, dw.to(a.dtype), win, nh, 32 ** -0.5),
              x3, _window_bwd_kind(32))
    lane = (lambda a: wa._lane_bwd(a, lmask, dl.to(a.dtype), 12, 0.125, P_ATTN, lseed),
            lambda a: wa.lane_self_attention_backward_plain(a, lmask, dl.to(a.dtype), 12, 0.125,
                                                            P_ATTN, lseed),
            xl, "attention_bwd")
    row5 = (lambda a: wa._lane_fwd(a, lmask, 12, 0.125, P_ATTN, lseed),
            lambda a: wa.lane_self_attention_plain(a, lmask, 12, 0.125, P_ATTN, lseed),
            xl, _lane_fwd_kind(64))
    ewin = (5, 7, 7)
    xe = torch.randn(2, 5, hp, hp, 3 * c, device=dev, generator=gen) * 0.5
    ebias = torch.randn(nh, 245, 245, device=dev, generator=gen) * 0.02
    emask = torch.from_numpy(_shift_attn_mask((5, hp, hp), ewin, (0, 3, 3))).to(dev)
    direct_fwd = (lambda a: wa._direct_fwd(a, ebias, emask, ewin, nh, 32 ** -0.5),
                  lambda a: wa.direct_window_attention_plain(a, ebias, emask, ewin, nh,
                                                             32 ** -0.5),
                  xe, _window_fwd_kind(32, 245))
    pbias = torch.randn(3, 196, 196, device=dev, generator=gen) * 0.02
    pmask = torch.from_numpy(_shift_attn_mask((4, 56, 56), win, (0, 3, 3))).to(dev)
    xp = torch.randn(128, 9, 196, 32, device=dev, generator=gen) * 0.5
    packed_fwd = (lambda a: wa._packed_fwd(a, pbias, pmask, 64, 3, 32 ** -0.5),
                  lambda a: wa.packed_window_attention_plain(a, pbias, pmask, 64, 3, 32 ** -0.5),
                  xp, _window_fwd_kind(32, 196))
    xw = torch.randn(32, 49, 3 * c, device=dev, generator=gen) * 0.5
    wbias = torch.randn(nh, 49, 49, device=dev, generator=gen) * 0.02
    wmask2d = torch.from_numpy(_shift_attn_mask((4, hp, hp), (1, 7, 7), (0, 3, 3))).to(dev)
    row7 = (lambda a: wa._lane_window_fwd(a, wbias, wmask2d, 16, nh, 32 ** -0.5),
            lambda a: wa.lane_window_attention_reference(a, wbias, wmask2d, 16, nh, 32 ** -0.5),
            xw, _window_fwd_kind(32, 49))
    xr = torch.randn(16, 196, 3 * c, device=dev, generator=gen) * 0.5
    rbias = torch.randn(nh, 196, 196, device=dev, generator=gen) * 0.1
    rmask = _shift_like_mask(dev, gen, 4, 196)
    row12 = (lambda a: wa._lane_attention_fwd(a, rbias, rmask, nh, 32 ** -0.5),
             lambda a: wa.lane_attention_reference(a, rbias, rmask, nh, 32 ** -0.5),
             xr, _window_fwd_kind(32, 196))
    checks = ((row11, {"row 11 forward": (fwd, fwd_plain, q64, "sa"), "row 5": row5},
               {"row 11 backward": (bwd, bwd_plain, q32, "sa_bwd")}),
              (rest, {"direct backward": window}, {"row 6": lane},
               {"direct forward": direct_fwd, "packed forward": packed_fwd, "row 7": row7,
                "row 12": row12}))
    real = _build.library()
    caught = {}
    try:
        for (lib, *per_fault), faults in zip(checks, PLANTED_COPIES):
            _build._lib = lib
            for fault, fault_checks in zip(faults, per_fault):
                caught[fault] = {where: bf16_check(*check)
                                 for where, check in fault_checks.items()}
    finally:
        _build._lib = real
    print(json.dumps({"planted_tiled_faults": {
        k: {where: dict(readings=r, failures=f) for where, (r, f) in v.items()}
        for k, v in caught.items()}, "build_s": build_s}), flush=True)
    return [f"planted fault passes the bf16 limits: {k} [{where}]"
            for k, v in caught.items() for where, (_, f) in v.items() if not f]


def _planted_ln_library(fault):
    """Build ``LN_SOURCES`` with the ``PLANTED_LN`` fault ``fault``; returns
    the loaded library (the LayerNorm entry points alone)."""
    src = _build.BUILD_DIR / f"planted_csrc_ln_{list(PLANTED_LN).index(fault)}"
    shutil.rmtree(src, ignore_errors=True)
    src.mkdir(parents=True)
    for name in LN_SOURCES:
        shutil.copy(_build.CSRC / name, src / name)
    plant(src, *PLANTED_LN[fault])
    return _build.load(_build.build(csrc=src), False)


def planted_ln_check(dev, gen):
    """Build the ``PLANTED_LN`` copies (at once) and hold each fault at the
    train fusion site (18,560 rows of 768, bf16), where each must fail: the
    one-pass variance the forward's bf16 limits at the ``LARGE_MEAN`` rows,
    the m2 fault dx's limits and the partial fault dgamma's or dbeta's
    (fp32 and bf16). Returns the faults that passed."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(PLANTED_LN)) as pool:
        libs = dict(zip(PLANTED_LN, pool.map(_planted_ln_library, PLANTED_LN)))
    build_s = time.perf_counter() - t0
    _, rows, c, eps, _ = TRAIN_LN[0]
    x, large, g, bt = _ln_inputs(dev, gen, rows, c)
    dy = _bf16_values(torch.randn(rows, c, device=dev, generator=gen))
    fwd, fwd_plain, _ = _ln_fwd_calls(g, bt, eps, c)
    bwd, bwd_plain, _ = _ln_bwd_calls(g, dy, eps, c)
    checks = {"one-pass variance": lambda: bf16_check(fwd, fwd_plain, large, "layer_norm"),
              "m2 dropped from dx": lambda: full_check(bwd, bwd_plain, x, "layer_norm_bwd"),
              "first partial left out of dgamma and dbeta": lambda: full_check(
                  bwd, bwd_plain, x, "layer_norm_bwd")}
    wants = {"one-pass variance": ("out",), "m2 dropped from dx": ("dx",),
             "first partial left out of dgamma and dbeta": ("dgamma", "dbeta")}
    real = _build.library()
    caught = {}
    try:
        for fault, lib in libs.items():
            _build._lib = lib
            caught[fault] = checks[fault]()
    finally:
        _build._lib = real
    print(json.dumps({"planted_ln_faults": {
        k: dict(readings=r, failures=f) for k, (r, f) in caught.items()}, "build_s": build_s}),
        flush=True)
    return [f"planted fault passes the LayerNorm limits: {k}" for k, (_, f) in caught.items()
            if not any(msg.startswith(wants[k]) for msg in f)]


def ln_bwd_cases(dev, gen):
    """The LayerNorm backward at the four sites of the train step, each also
    at ``LARGE_MEAN``; dgamma and dbeta of two runs bit-identical."""
    recs = []
    for label, rows, c, eps, work in TRAIN_LN:
        x, large, g, _ = _ln_inputs(dev, gen, rows, c)
        dy = _bf16_values(torch.randn(rows, c, device=dev, generator=gen))
        calls = _ln_bwd_calls(g, dy, eps, c)
        item = torch.finfo(work).bits // 8
        rec = measure("fused_layer_norm_bwd", f"{label} rows={rows} C={c} eps={eps}", x,
                      *calls, work, "layer_norm_bwd", 16 * rows * c, "fp32",
                      3 * rows * c * item + 3 * c * 4)
        rec = _ln_record(rec, "layer_norm_bwd", calls, x, large, c, work)
        a = x.to(work)
        first, second = calls[0](a)[1:], calls[0](a)[1:]
        rec["dgamma_dbeta_bit_identical"] = all(map(torch.equal, first, second))
        if not rec["dgamma_dbeta_bit_identical"]:
            rec["failures"].append(f"fused_layer_norm_bwd [{rec['shape']}] dgamma, dbeta differ "
                                   "between two runs")
        recs.append(rec)
    recs[0]["failures"] += planted_ln_check(dev, gen)
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


def with_mvm_target(run, target):
    """``run`` with ``train.mvm_target`` replaced, as bench.py builds the
    2d_feature model from configs/pretrain.json."""
    return dataclasses.replace(run, train=dataclasses.replace(run.train, mvm_target=target))


def with_swin2d_backbone(run):
    """``run`` with the trained 2D Swin backbone (``vis_backbone`` "swin2d",
    concat fusion) in place of the Video Swin."""
    return dataclasses.replace(run, model=dataclasses.replace(
        run.model, vis_backbone="swin2d", temporal_fusion="concat"))


def with_violet_backbone(run):
    """``run`` with the C = 96 Video Swin of the reference's
    ``swin_violet.py`` (``vis_backbone_size`` "violet") in place of
    Swin-base."""
    return dataclasses.replace(run, model=dataclasses.replace(run.model,
                                                              vis_backbone_size="violet"))


def backbone_config(cfg):
    """The SwinConfig the model's image encoder builds."""
    if cfg.vis_backbone in ("swin", "swin2d") and cfg.swin_custom is None:
        return swin2d_config(cfg.vis_backbone_size)
    return cfg.swin


def _teacher(name):
    return name.startswith(("feature_model.", "clip_model."))


def _event_ms(fn) -> float:
    """Device time of one call of fn, from CUDA events around it."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def target_times(model, img):
    """Device ms of one no-grad call of each MVM teacher of ``model`` on the
    normalized clips ``img`` (``feature_model`` on the clips, ``clip_model``
    on their frames, CLIP-normalized) and of ``hog_image``, as the step
    makes its targets."""
    b, t = img.shape[:2]
    calls = {}
    if hasattr(model, "feature_model"):
        calls["feature_model"] = lambda: model.feature_model(img)
    if hasattr(model, "clip_model"):
        frames = renormalize_imagenet_to_clip(img.reshape(b * t, *img.shape[2:]))
        calls["clip_model"] = lambda: model.clip_model.features(frames)
    if "hog" in model.mvm_target:
        calls["hog_image"] = lambda: hog_image(img)
    with torch.no_grad():
        return {name: _event_ms(fn) for name, fn in calls.items()}


VTM_OUT_BIAS = "fc.3.bias"


def train_phase(dev, run, want_launches):
    """Phases 6, 8, 10, 12 and 18-20: the pretrain train step at full width
    for the run's backbone and MVM target. Returns the launch counts of the
    first timed step, which must equal ``want_launches``. After the timed
    steps, the MVM teachers' and HOG's device time of one no-grad call each
    (``target_times``)."""
    cfg = run.model
    b = run.train.size_batch
    model = VioletPretrain.from_run_config(run, dtype=torch.bfloat16, device=dev,
                                           seed=TRAIN_SEED)
    opt = build_optimizer(model, run.train, TRAIN_MAX_ITER)
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
    target = run.train.mvm_target
    targets_ms = target_times(model, maybe_normalize(batch["img"]))
    backbone = f"{cfg.vis_backbone}-{cfg.vis_backbone_size}"
    print(f"train-step {backbone} {target} launch counts: {launches}", flush=True)
    print(json.dumps({
        "slice": "pretrain_train_step", "config": PRETRAIN_CONFIG.name,
        "vis_backbone": cfg.vis_backbone, "vis_backbone_size": cfg.vis_backbone_size,
        "mvm_target": list(target), "dtype": "bfloat16",
        "batch": b, "frames": cfg.size_frame, "size_img": cfg.size_img,
        "size_txt": cfg.size_txt, "steps": TRAIN_STEPS, "warmup_step_s": warm_s,
        "clips_per_s": float(np.median(clips_s)), "clips_per_s_range": [min(clips_s),
                                                                          max(clips_s)],
        "step_ms_median": float(np.median(secs)) * 1e3, "step_s_each": secs,
        "peak_mem_gib": peak, "losses_each_step": losses,
        "target_ms_one_call": targets_ms}), flush=True)
    require(launches == want_launches,
            f"launches of one {backbone} {target} train step {launches}, "
            f"not {want_launches}")
    for i, step_ls in enumerate(losses):
        require(all(np.isfinite(v) for v in step_ls.values()),
                f"non-finite loss at step {i}: {step_ls}")
    # no gradient: the frame-order embedding, which the pretrain forward does
    # not use, and the frozen teachers, which must also be bit-unchanged
    teacher = {n for n in state.params if _teacher(n)}
    require(bool(teacher) == bool(TEACHER_TARGETS & set(target)),
            f"teacher parameters: {len(teacher)}")
    no_grad = {n for n, p in state.params.items() if p.grad is None}
    odr = {n for n in state.params if n.endswith(".emb_odr")}
    require(len(odr) == 1 and no_grad == teacher | odr,
            f"parameters without a gradient: {sorted(no_grad - teacher)} and "
            f"{len(no_grad & teacher)} of the {len(teacher)} teacher parameters")
    moved = [n for n in teacher if not torch.equal(before[n], state.params[n].detach())]
    require(not moved, f"frozen teacher parameters changed: {moved}")
    # The VTM score head's output bias has a gradient that is zero in exact
    # arithmetic (the softmax over the options is shift-invariant); in bf16
    # it may round to exactly 0 in every step, and Adam then leaves the bias
    # as it was. It alone may end with an all-zero gradient; every other
    # parameter with a gradient must have moved.
    zero = {n for n, p in state.params.items() if n not in no_grad and not p.grad.any()}
    print(f"parameters whose last gradient is exactly 0: {sorted(zero)}", flush=True)
    require(zero <= {VTM_OUT_BIAS}, f"all-zero last gradients: {sorted(zero - {VTM_OUT_BIAS})}")
    unchanged = [n for n, p in state.params.items()
                 if n not in no_grad | zero and torch.equal(before[n], p.detach())]
    require(not unchanged, f"parameters unchanged after {TRAIN_STEPS + 1} steps: {unchanged}")
    return launches


def whole_step_phase(dev, run):
    """Phases 7, 9, 11, 13 and 21: one train step of a depth-cut copy (the
    student; the teachers keep their full depth), card fp32 (kernels)
    against CPU fp32 (plain versions). With the hog target, both sides are
    fed the same ``hog`` target, computed once on the CPU, and
    ``hog_image`` is held card against CPU apart (``hog_check``)."""
    cfg = run.model
    cut = dataclasses.replace(
        cfg, swin_custom=dataclasses.replace(backbone_config(cfg), depths=(2, 2, 2, 2),
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
    if "hog" in run.train.mvm_target:
        hog_check(dev, maybe_normalize(batch["img"]))
        batch["hog"] = hog_image(maybe_normalize(batch["img"]))
    card = VioletPretrain.from_run_config(run_cut, dtype=torch.float32, device=dev, seed=1)
    cpu = VioletPretrain.from_run_config(run_cut, dtype=torch.float32, device="cpu", seed=1)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    results, secs = {}, {}
    for name, model, device in (("card", card, dev), ("cpu", cpu, torch.device("cpu"))):
        for head in ("fc", "fc_mvm", "fc_mvm_clip"):  # the score heads' dropout, 0.1
            if hasattr(model, head):
                getattr(model, head)[0].p = 0.0
        opt = build_optimizer(model, run.train, TRAIN_MAX_ITER)
        step = make_pretrain_train_step(model, opt)
        on_dev = {k: (type(v)(*(t.to(device) for t in v)) if k == "draws" else v.to(device))
                  for k, v in batch.items()}
        t0 = time.perf_counter()
        _, ls = step(create_train_state(model, opt), on_dev, 0)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        secs[name] = time.perf_counter() - t0
        results[name] = _step_results(model, ls)
    hold_card_against_cpu(results, secs, {
        "vis_backbone": cut.vis_backbone, "vis_backbone_size": cut.vis_backbone_size,
        "mvm_target": list(run.train.mvm_target), "swin_depths": list(cut.swin.depths),
        "fusion_layers": cut.fusion.num_hidden_layers, "batch": b})


def hog_check(dev, img):
    """``hog_image`` of the normalized clips ``img`` (on the CPU) on the card
    against the CPU: the share of pixels in another orientation bin held to
    ``HOG_FLIP_SHARE``, the rendering of the cells where none is to
    ``HOG_CELL_SCALE`` of its largest value; both printed."""
    bins_c, _ = hog_bins(img)
    bins_d, _ = hog_bins(img.to(dev))
    flipped = bins_d.cpu() != bins_c                           # (B, T, H, W)
    want, got = hog_image(img), hog_image(img.to(dev)).cpu()
    b, t, h, w = flipped.shape
    cell = flipped.reshape(b, t, h // 8, 8, w // 8, 8).any(5).any(3)
    clean = ~cell.repeat_interleave(8, 2).repeat_interleave(8, 3)
    share = flipped.float().mean().item()
    diff = (got - want).abs()
    clean_max = diff[clean].max().item()
    scale = want.abs().max().item()
    print(json.dumps({"hog_card_vs_cpu": {
        "pixels": flipped.numel(), "share_in_another_bin": share,
        "cells_with_a_changed_bin": int(cell.sum()), "max_abs_diff": diff.max().item(),
        "max_abs_diff_clean_cells": clean_max, "max_abs": scale,
        "limits": {"share": HOG_FLIP_SHARE, "clean_cells": HOG_CELL_SCALE * scale}}}),
          flush=True)
    require(share <= HOG_FLIP_SHARE, f"hog: {share} of the pixels in another bin")
    require(clean_max <= HOG_CELL_SCALE * scale,
            f"hog: {clean_max} apart in cells where no bin changed")


def _step_results(model, ls):
    """A step's losses and every parameter's gradient (zeros where None), on
    the CPU."""
    return ({k: v.item() for k, v in ls.items()},
            {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().float().cpu()
             for n, p in model.named_parameters()})


def hold_card_against_cpu(results, secs, info, zero=()):
    """Hold the card's step (``results["card"]``: losses, gradients) to the
    CPU's with ``WHOLE_STEP_TOL``; print the differences. The parameters in
    ``zero`` have gradients that are zero in exact arithmetic: each side's
    is held to ``ZERO_GRAD_ATOL`` instead of to the other's roundoff."""
    (ls_c, g_c), (ls_r, g_r) = results["card"], results["cpu"]
    tol = WHOLE_STEP_TOL
    g_all = max(g.abs().max().item() for g in g_r.values())
    worst, fails = [], []
    for n in zero:
        got = max(g_c[n].abs().max().item(), g_r[n].abs().max().item())
        if got > ZERO_GRAD_ATOL:
            fails.append(f"{n}: gradient {got:.3g}, zero in exact arithmetic")
    for n, g in g_r.items():
        if n in zero:
            continue
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
        **info, "losses_card": ls_c, "losses_cpu": ls_r, "loss_abs_diff": loss_diff,
        "grad_global_max": g_all, "params": len(g_r), "step_s": secs,
        "worst_grads": [dict(param=n, max_abs_diff=d, fraction_of_limit=r)
                        for r, n, d in worst[:8]]}}), flush=True)
    require(not fails, "whole train step, card against CPU:\n" + "\n".join(fails))


# ---------------------------------------------------------------------------
# phases 14-16: the multiple-choice QA fine-tune step and eval
# ---------------------------------------------------------------------------

def synthetic_qamc_batch(b, cfg, seed, device):
    """``b`` seeded uint8 clips, each with ``size_option`` rows of a question
    and an option of 8 to size_txt tokens ([CLS] ... [SEP], zero-padded),
    their padding mask, and a seeded answer per clip."""
    rs = np.random.RandomState(seed)
    o, x = cfg.size_option, cfg.size_txt
    txt = np.zeros((b, o, x), np.int32)
    for row in txt.reshape(b * o, x):
        n = rs.randint(8, x + 1)
        row[:n] = rs.randint(1000, cfg.text.vocab_size, n)
        row[0], row[n - 1] = 101, 102
    img = rs.randint(0, 256, (b, cfg.size_frame, cfg.size_img, cfg.size_img, 3))
    return {"img": torch.from_numpy(img.astype(np.uint8)).to(device),
            "txt": torch.from_numpy(txt).to(device),
            "mask": torch.from_numpy((txt > 0).astype(np.int32)).to(device),
            "ans": torch.from_numpy(rs.randint(0, o, b)).to(device)}


# the score head's output bias: shared by the options, so its gradient under
# the cross entropy over them is zero in exact arithmetic (as VTM_OUT_BIAS)
QAMC_OUT_BIAS = "fc.3.bias"


def qamc_train_phase(dev, run):
    """Phase 14: the multiple-choice fine-tune step at full width. Returns
    its launch counts (held to ``TRAIN_QAMC_LAUNCHES``) and the trained
    model, which phase 16 evaluates."""
    cfg = run.model
    b = run.train.size_batch
    model = VioletQAMC(cfg, dtype=torch.bfloat16, device=dev, seed=TRAIN_SEED)
    opt = build_optimizer(model, run.train, TRAIN_MAX_ITER)
    state = create_train_state(model, opt)
    step = make_supervised_train_step(model, opt, "ce")
    batch = synthetic_qamc_batch(b, cfg, seed=6, device=dev)
    before = {n: p.detach().clone() for n, p in state.params.items()}
    t0 = time.perf_counter()
    state, ls = step(state, batch, TRAIN_SEED)             # warm-up: first launches, cuBLAS
    torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0
    losses = [ls["total"].item()]
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
        losses.append(ls["total"].item())
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    qps = [b / t for t in secs]
    print(f"qamc train-step launch counts: {launches}", flush=True)
    print(json.dumps({
        "slice": "qamc_train_step", "config": QAMC_CONFIG.name, "dtype": "bfloat16",
        "batch": b, "options": cfg.size_option, "frames": cfg.size_frame,
        "size_img": cfg.size_img, "size_txt": cfg.size_txt, "fusion_rows": b * cfg.size_option,
        "fusion_tokens": cfg.size_frame * cfg.tokens_per_frame + cfg.size_txt,
        "steps": TRAIN_STEPS, "warmup_step_s": warm_s,
        "questions_per_s": float(np.median(qps)), "questions_per_s_range": [min(qps), max(qps)],
        "step_ms_median": float(np.median(secs)) * 1e3, "step_s_each": secs,
        "peak_mem_gib": peak, "losses_each_step": losses}), flush=True)
    require(launches == TRAIN_QAMC_LAUNCHES,
            f"launches of one qamc train step {launches}, not {TRAIN_QAMC_LAUNCHES}")
    require(all(np.isfinite(v) for v in losses), f"non-finite loss: {losses}")
    no_grad = {n for n, p in state.params.items() if p.grad is None}
    require(no_grad == {"enc_img.emb_odr"}, f"parameters without a gradient: {sorted(no_grad)}")
    zero = {n for n, p in state.params.items() if n not in no_grad and not p.grad.any()}
    print(f"parameters whose last gradient is exactly 0: {sorted(zero)}", flush=True)
    require(zero <= {QAMC_OUT_BIAS}, f"all-zero last gradients: {sorted(zero - {QAMC_OUT_BIAS})}")
    unchanged = [n for n, p in state.params.items()
                 if n not in no_grad | zero and torch.equal(before[n], p.detach())]
    require(not unchanged, f"parameters unchanged after {TRAIN_STEPS + 1} steps: {unchanged}")
    return launches, model


def qamc_whole_step_phase(dev, run):
    """Phase 15: one multiple-choice step of a depth-cut copy (swin depths
    (2, 2, 2, 2), 2 fusion layers, batch 2, every rate 0) at full widths and
    L = 350, so the fusion still takes the tiled kernel: card fp32 against
    CPU fp32."""
    cfg = run.model
    cut = dataclasses.replace(
        cfg, swin_custom=dataclasses.replace(cfg.swin, depths=(2, 2, 2, 2), drop_path_rate=0.0),
        fusion=dataclasses.replace(cfg.fusion, num_hidden_layers=2, hidden_dropout_prob=0.0,
                                   attention_probs_dropout_prob=0.0),
        text=dataclasses.replace(cfg.text, hidden_dropout_prob=0.0))
    b = 2
    fused = cut.size_frame * cut.tokens_per_frame + cut.size_txt
    require(not wa.lane_sa_attention_fits(b * cut.size_option, fused, cut.hidden_size,
                                          cut.fusion.num_attention_heads),
            f"the cut multiple-choice fusion over {fused} tokens would take the lane kernel")
    batch = synthetic_qamc_batch(b, cut, seed=7, device="cpu")
    card = VioletQAMC(cut, dtype=torch.float32, device=dev, seed=1)
    cpu = VioletQAMC(cut, dtype=torch.float32, device="cpu", seed=1)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    results, secs = {}, {}
    _build.launch_counts.clear()
    for name, model, device in (("card", card, dev), ("cpu", cpu, torch.device("cpu"))):
        model.fc[0].p = 0.0                 # the score head's dropout, fixed at 0.1
        opt = build_optimizer(model, run.train, TRAIN_MAX_ITER)
        step = make_supervised_train_step(model, opt, "ce")
        t0 = time.perf_counter()
        _, ls = step(create_train_state(model, opt), {k: v.to(device) for k, v in batch.items()},
                     0)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        secs[name] = time.perf_counter() - t0
        results[name] = _step_results(model, ls)
    require(_build.launch_counts["packed_self_attention_bwd"] == 2,
            f"the cut card step's launches: {dict(_build.launch_counts)}")
    hold_card_against_cpu(results, secs, {
        "slice": "qamc", "swin_depths": list(cut.swin.depths),
        "fusion_layers": cut.fusion.num_hidden_layers, "batch": b,
        "fusion_rows": b * cut.size_option, "fusion_tokens": fused,
        "zero_in_exact_arithmetic": {QAMC_OUT_BIAS: [results[k][1][QAMC_OUT_BIAS].abs().max()
                                                     .item() for k in ("card", "cpu")]}},
        zero=(QAMC_OUT_BIAS,))


def qamc_eval_phase(dev, model, run):
    """Phase 16: ``make_eval_step`` on ``QAMC_EVAL_BATCHES`` seeded batches
    (one warm-up batch first) and ``qamc_accuracy`` over them, as cli/qa.py
    scores a split; each batch launches ``EVAL_QAMC_LAUNCHES``."""
    cfg = run.model
    b = run.train.size_batch
    eval_step = make_eval_step(model)
    batches = [synthetic_qamc_batch(b, cfg, seed=20 + i, device=dev)
               for i in range(QAMC_EVAL_BATCHES + 1)]
    eval_step(batches[0])
    torch.cuda.synchronize(dev)
    _build.launch_counts.clear()
    accs, secs = [], []
    for batch in batches[1:]:
        t0 = time.perf_counter()
        logits = eval_step(batch)
        torch.cuda.synchronize(dev)
        secs.append(time.perf_counter() - t0)
        require(logits.shape == (b, cfg.size_option) and torch.isfinite(logits).all(),
                f"eval logits {tuple(logits.shape)}, finite: {torch.isfinite(logits).all()}")
        accs.append(qamc_accuracy(logits.float().cpu().numpy(), batch["ans"].cpu().numpy()))
    launches = dict(_build.launch_counts)
    want = {k: v * QAMC_EVAL_BATCHES for k, v in EVAL_QAMC_LAUNCHES.items()}
    accuracy = float(np.mean(accs))
    qps = [b / t for t in secs]
    print(json.dumps({
        "slice": "qamc_eval", "config": QAMC_CONFIG.name, "dtype": "bfloat16", "batch": b,
        "batches": QAMC_EVAL_BATCHES, "accuracy": accuracy, "accuracy_each": accs,
        "questions_per_s": float(np.median(qps)), "questions_per_s_range": [min(qps), max(qps)],
        "launches": launches}), flush=True)
    require(launches == want, f"launches of {QAMC_EVAL_BATCHES} qamc evals {launches}, not {want}")
    require(0.0 <= accuracy <= 1.0, f"accuracy {accuracy}")
    return {k: v // QAMC_EVAL_BATCHES for k, v in launches.items()}


def lanebench_phase():
    """Phase 17: the lanebench tool (``empirical_mvm_torch.tools.lanebench``)
    as its command line runs it, ``--stage -1 --grad``, in this process: its
    lines, and each path's largest error against the tool's fp32 oracle held
    to phase 3's bf16 limit against plain fp32 (``BF16_VS_FP32["attention"]``,
    shared by the ``attention`` and ``window_fwd_tc`` kinds). Returns the tool's
    launch counts, in which ``lane_attention`` must appear."""
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    recs = lanebench.main(["--stage", "-1", "--grad"])
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    limit = BF16_VS_FP32["attention"]["atol"]
    print(json.dumps({"slice": "lanebench", "records": recs, "launches": launches,
                      "err_limit": limit, "s": time.perf_counter() - t0}), flush=True)
    require(sorted(r["stage"] for r in recs) == sorted(lanebench.SHAPES),
            f"lanebench ran stages {[r['stage'] for r in recs]}")
    for r in recs:
        require(r["err_lane"] <= limit and r["err_packed"] <= limit,
                f"lanebench stage{r['stage']}: errors {r['err_lane']}, {r['err_packed']} "
                f"above {limit}")
    require(launches.get("lane_attention", 0) >= len(recs),
            f"lanebench launched lane_attention {launches.get('lane_attention', 0)} times")
    return launches


def _shared_bwd_calls(dev, gen):
    """(kernel, label, x3, call, plain, kind) of each backward whose bf16 runs
    a tensor-core body, at the shapes phase 3 times it: the window backwards
    of attention_bwd_mma.cuh (rows 4 and 8: ``_direct_bwd_inputs``,
    ``_window_bwd_inputs``; rows 9 and 10: ``_packed_shapes``, the split
    entry at the violet stage-0 shifted shape) and row 6 (the fusion of the
    train step, p = 0.1); ``call(a)`` launches the kernel on a (a dtype of
    x3) with the shape's do, bias and mask, ``plain(a)`` its plain version,
    ``kind`` names the bf16 limits."""
    for stage, win, nh, x3, do, bias, mask in _direct_bwd_inputs(dev, gen):
        hd = x3.shape[-1] // 3 // nh
        args = (bias, mask, do, win, nh, hd ** -0.5)
        yield ("direct_window_attention_bwd",
               f"stage{stage} {'shifted' if mask is not None else 'unshifted'}", x3,
               functools.partial(_with_do, wa._direct_bwd, args),
               functools.partial(_with_do, wa.direct_window_attention_backward_plain, args),
               _window_bwd_kind(hd))
    for stage, nw, nh, x3, do, bias, mk, _ in _window_bwd_inputs(dev, gen):
        args = (bias, mk, do, nw if mk is not None else 1, nh, 32 ** -0.5)
        yield ("lane_window_attention_bwd",
               f"2d stage{stage} {'shifted' if mk is not None else 'unshifted'}", x3,
               functools.partial(_with_do, wa._lane_window_bwd, args),
               functools.partial(_with_do, wa.lane_window_attention_backward_plain, args),
               _window_bwd_kind(32))
    for label, nw, c, nh, n, mk, _ in _packed_shapes():
        qkv = torch.randn(TRAIN_B * nw, 3 * nh, n, 32, device=dev, generator=gen) * 0.5
        do = _bf16_values(torch.randn(TRAIN_B * nw, nh, n, 32, device=dev, generator=gen))
        bias = torch.randn(nh, n, n, device=dev, generator=gen) * 0.02
        mk = None if mk is None else torch.from_numpy(mk).to(dev)
        args = (bias, mk, do, nw if mk is not None else 1, nh, 32 ** -0.5)
        label = f"{label} {'shifted' if mk is not None else 'unshifted'}"
        yield ("packed_window_attention_bwd", label, qkv,
               functools.partial(_with_do, wa._packed_bwd, args),
               functools.partial(_with_do, wa.packed_window_attention_backward_plain, args),
               _window_bwd_kind(32))
        if label == "violet stage0 shifted":
            stack = qkv.reshape(-1, 3, nh, n, 32).transpose(0, 1).contiguous()
            args = (bias, mk, do, nw, 32 ** -0.5)
            yield ("fused_window_attention_bwd", label, stack,
                   functools.partial(_with_do, _split(wa._fused_bwd), args),
                   functools.partial(_with_do, _split(wa.fused_window_attention_backward_plain),
                                     args),
                   _window_bwd_kind(32, split=True))
    b, l = 4 * TRAIN_B, TRAIN_L
    x3 = torch.randn(b, l, 3 * 768, device=dev, generator=gen) * 0.5
    do = _bf16_values(torch.randn(b, l, 768, device=dev, generator=gen))
    seed = torch.tensor([20261016, 7], dtype=torch.int32, device=dev)
    args = (_padding_mask(dev, gen, b, l, 32, 6), do, 12, 0.125, P_ATTN, seed)
    yield ("lane_self_attention_bwd", f"train p_drop={P_ATTN}", x3,
           functools.partial(_with_do, wa._lane_bwd, args, at=1),
           functools.partial(_with_do, wa.lane_self_attention_backward_plain, args, at=1),
           "attention_bwd")


def _with_do(fn, args, a, at=2):
    """fn(a, *args) with args[at], the cotangent, cast to a's dtype."""
    args = list(args)
    args[at] = args[at].to(a.dtype)
    return fn(a, *args)


def _split(fn):
    """fn on a (3, ...) stack of q, k, v: fn(q, k, v, ...)."""
    return lambda a, *args: fn(*a.unbind(0), *args)


def _redesigned_fwd_calls(dev, gen):
    """(kernel, label, x3, call, plain, kind) of each forward whose bf16 runs
    a tensor-core body since rows 3, 5, 7, 9, 10 and 12 were redesigned, at
    the main-path shapes phase 3 times: the direct forward (row 3) at the
    train step's stages (``_direct_bwd_inputs``), the eval's (32 clips of 5
    frames, N = 245) and the violet step's stages 2 and 3; the lane
    self-attention (row 5) at the eval's fusion (p = 0), the train step's (p
    = 0.1) and the CLIP teacher's shape; the packed forward (row 9) at
    ``_packed_shapes``; the fused forward (row 10) at the violet stage-0
    shifted shape; the lane window forward (row 7) at the 2D swin's shapes
    (``_window_bwd_inputs``); ``lane_attention`` (row 12) at the lanebench
    tool's stage shapes with its zero mask and a shift-like mask. ``kind``
    names the bf16 limits of this checkout's body."""
    direct = itertools.chain(
        (("train", *x) for x in _direct_bwd_inputs(dev, gen)),
        (("eval", *x) for x in _direct_bwd_inputs(dev, gen, b=ITEMS * CLIPS, t=5)),
        (("violet", *x) for x in _direct_bwd_inputs(dev, gen, SwinConfig.violet(), (2, 3))))
    for path, stage, win, nh, x3, _, bias, mask in direct:
        hd, n = x3.shape[-1] // 3 // nh, bias.shape[-1]
        args = (bias, mask, win, nh, hd ** -0.5)
        yield ("direct_window_attention",
               f"{path} stage{stage} {'shifted' if mask is not None else 'unshifted'}", x3,
               functools.partial(_with_args, wa._direct_fwd, args),
               functools.partial(_with_args, wa.direct_window_attention_plain, args),
               _window_fwd_kind(hd, n))
    seed = torch.tensor([20261016, 7], dtype=torch.int32, device=dev)
    for label, b, l, text, p_drop in (("eval", CHUNK, 275, 25, 0.0),
                                      ("train", 4 * TRAIN_B, TRAIN_L, 32, P_ATTN),
                                      ("2d_clip teacher", TRAIN_B * TRAIN_T, 50, 0, 0.0)):
        x3 = torch.randn(b, l, 3 * 768, device=dev, generator=gen) * 0.5
        mask = (_padding_mask(dev, gen, b, l, text, 3) if text
                else torch.zeros(1, 1, l, device=dev).expand(b, l, l))
        args = (mask, 12, 0.125, p_drop, seed if p_drop else None)
        yield ("lane_self_attention" if p_drop == 0 else "lane_self_attention_dropout",
               f"{label} p_drop={p_drop}", x3, functools.partial(_with_args, wa._lane_fwd, args),
               functools.partial(_with_args, wa.lane_self_attention_plain, args),
               _lane_fwd_kind(64))
    for label, nw, c, nh, n, mk, _ in _packed_shapes():
        qkv = torch.randn(TRAIN_B * nw, 3 * nh, n, 32, device=dev, generator=gen) * 0.5
        bias = torch.randn(nh, n, n, device=dev, generator=gen) * 0.02
        mk = None if mk is None else torch.from_numpy(mk).to(dev)
        args = (bias, mk, nw if mk is not None else 1, nh, 32 ** -0.5)
        label = f"{label} {'shifted' if mk is not None else 'unshifted'}"
        yield ("packed_window_attention", label, qkv,
               functools.partial(_with_args, wa._packed_fwd, args),
               functools.partial(_with_args, wa.packed_window_attention_plain, args),
               _window_fwd_kind(32, n))
        if label == "violet stage0 shifted":
            stack = qkv.reshape(-1, 3, nh, n, 32).transpose(0, 1).contiguous()
            args = (bias, mk, nw, 32 ** -0.5)
            yield ("fused_window_attention", label, stack,
                   functools.partial(_with_args, _split(wa._fused_fwd), args),
                   functools.partial(_with_args, _split(wa.fused_window_attention_plain), args),
                   _window_fwd_kind(32, n))
    for stage, nw, nh, x3, _, bias, mk, _ in _window_bwd_inputs(dev, gen):
        args = (bias, mk, nw if mk is not None else 1, nh, 32 ** -0.5)
        yield ("lane_window_attention",
               f"2d stage{stage} {'shifted' if mk is not None else 'unshifted'}", x3,
               functools.partial(_with_args, wa._lane_window_fwd, args),
               functools.partial(_with_args, wa.lane_window_attention_reference, args),
               _window_fwd_kind(32, x3.shape[1]))
    for stage, sh in lanebench.SHAPES.items():
        b_, n, c, nh, nw = (sh[k] for k in ("b_", "n", "c", "nh", "nw"))
        x3 = torch.randn(b_, n, 3 * c, device=dev, generator=gen) * 0.5
        bias = torch.randn(nh, n, n, device=dev, generator=gen) * 0.1
        for name, mask in (("zero mask", torch.zeros(nw, n, n, device=dev)),
                           ("shift-like mask", _shift_like_mask(dev, gen, nw, n))):
            args = (bias, mask, nh, (c // nh) ** -0.5)
            yield ("lane_attention", f"lanebench stage{stage} {name}", x3,
                   functools.partial(_with_args, wa._lane_attention_fwd, args),
                   functools.partial(_with_args, wa.lane_attention_reference, args),
                   _window_fwd_kind(c // nh, n))


def _with_args(fn, args, a):
    """fn(a, *args)."""
    return fn(a, *args)


def _tiled_calls(dev, gen):
    """(kernel, label, qkv, calls, kind) of row 11 at the multiple-choice
    fusion shape (40 rows of 350, 12 heads of 64, the padding mask):
    forward at p = 0 and p = 0.1, backward at p = 0.1. ``calls()`` returns a
    fresh (kernel call, plain version) pair, so that each build's backward
    runs from its own forward's stats."""
    b, nh, n, hd = QAMC_B * QAMC_O, 12, QAMC_L, 64
    qkv = torch.randn(b, 3 * nh, n, hd, device=dev, generator=gen) * 0.5
    do = _bf16_values(torch.randn(b, nh, n, hd, device=dev, generator=gen))
    mask = _padding_mask(dev, gen, b, n, 100, 8)
    seed = torch.tensor([20261016, 11], dtype=torch.int32, device=dev)

    def calls(p_drop, backward):
        return _sa_calls(mask, nh, hd ** -0.5, p_drop, seed if p_drop else None,
                         do)[backward][:2]

    for p_drop in (0.0, P_ATTN):
        label = f"mc fusion p_drop={p_drop}"
        yield "packed_self_attention", label, qkv, functools.partial(calls, p_drop, 0), "sa"
        if p_drop:
            yield ("packed_self_attention_bwd", label, qkv, functools.partial(calls, p_drop, 1),
                   "sa_bwd")


def _ln_sites():
    """(kernel, label, rows, C, eps, dtype) of every LayerNorm site of the
    paths: the forward at ``EVAL_LN``, ``TRAIN_LN``, ``TEACHER3D_LN`` (the
    2D teacher's sites and the 3D teacher's final norm) and ``CLIP_LN``, the
    backward at ``TRAIN_LN``."""
    for path, sites in (("eval", EVAL_LN), ("train", TRAIN_LN), ("teacher", TEACHER3D_LN),
                        ("clip teacher", CLIP_LN)):
        for label, rows, c, eps, work in sites:
            yield "fused_layer_norm", f"{path} {label} rows={rows} C={c}", rows, c, eps, work
    for label, rows, c, eps, work in TRAIN_LN:
        yield "fused_layer_norm_bwd", f"{label} rows={rows} C={c}", rows, c, eps, work


# train steps of each build in --compare-build: STEP_TURNS steps a turn,
# after one warm-up step with each build
STEP_TURNS = 3


def _step_calls(dev):
    """(label, one_step) of the pixel, violet, 2d_feature (the frozen 2D
    teacher on row 7) and swin2d (the trained 2D swin on rows 7 and 8)
    pretrain steps and the multiple-choice step at full width, each model
    built once: one_step() runs one step, ending in a synchronise (the
    parameters move from step to step, which the times do not depend on)."""
    run = load_run_config(str(PRETRAIN_CONFIG))
    for label, r in (("pixel", run), ("violet", with_violet_backbone(run)),
                     ("2d_feature", with_mvm_target(run, ("2d_feature",))),
                     ("swin2d", with_swin2d_backbone(run))):
        model = VioletPretrain.from_run_config(r, dtype=torch.bfloat16, device=dev,
                                               seed=TRAIN_SEED)
        opt = build_optimizer(model, r.train, TRAIN_MAX_ITER)
        step = make_pretrain_train_step(model, opt)
        batch = synthetic_pretrain_batch(r.train.size_batch, r.model, seed=3, device=dev)
        yield f"train step {label}", _stepper(step, create_train_state(model, opt), batch)
        del model, opt, step, batch
        torch.cuda.empty_cache()
    run = load_run_config(str(QAMC_CONFIG))
    model = VioletQAMC(run.model, dtype=torch.bfloat16, device=dev, seed=TRAIN_SEED)
    opt = build_optimizer(model, run.train, TRAIN_MAX_ITER)
    step = make_supervised_train_step(model, opt, "ce")
    batch = synthetic_qamc_batch(run.train.size_batch, run.model, seed=6, device=dev)
    yield "train step qamc", _stepper(step, create_train_state(model, opt), batch)


def _kernel_ms(one_step):
    """The ms that CUDA kernels ran during one call of ``one_step``
    (torch.profiler, CUDA activity alone); the rest of the step's time the
    device waits for the host."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        one_step()
    return sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
               for e in prof.key_averages() if str(e.device_type).endswith("CUDA")) / 1e3


def _stepper(step, state, batch):
    """A zero-argument call of one train step on ``state``, synchronised."""
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], batch, TRAIN_SEED)
        torch.cuda.synchronize()

    return one_step


def compare_builds(base_csrc: Path) -> None:
    """Build the kernel library from ``base_csrc`` too and hold this
    checkout's build against it, times of both builds' bf16 calls taken with
    CUDA events in turns (base, new, new, base):
    * the forwards whose bf16 runs a tensor-core body since their redesign
      (``_redesigned_fwd_calls``: rows 3, 5, 7, 9, 10, 12): fp32
      bit-identical (the CUDA-core bodies), each build's bf16 held to the
      bf16 limits of this checkout's body (which take the CUDA-core body's
      readings too), and whether bf16 is bit-identical printed (a body
      that neither build changed reads true);
    * the backwards whose bf16 runs a tensor-core body (``_shared_bwd_calls``:
      rows 4, 6, 8, 9, 10) and row 11 forward and backward (``_tiled_calls``):
      fp32 and bf16 bit-identical, each build's bf16 held to its limits;
    * the LayerNorm forward and backward (rows 1 and 2) at every site of the
      paths (``_ln_sites``), timed in the site's dtype: each build's fp32
      and bf16 held to the ``layer_norm`` / ``layer_norm_bwd`` limits (the
      bodies' sum orders differ, so their bits may), and the body this
      checkout's build runs there;
    * the pixel, violet, 2d_feature and swin2d train steps and the
      multiple-choice step (``_step_calls``): host seconds of ``STEP_TURNS``
      steps a turn, after one warm-up step with each build, their medians
      per build; then two steps of each build under torch.profiler, in
      turns: the mean ms their kernels ran, and the device's idle share of
      the median step (``_kernel_ms``).
    Size queries that the base build predates (``*_smem_bytes`` entry
    points, which feed only the wrappers' shared-memory check before a
    launch) are answered by this build's. Prints one JSON line per shape and
    the sums per kernel with new / base; exits non-zero if an output differs
    or a limit is exceeded."""
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(_nvidia_smi(), flush=True)
    libs = {"new": _build.library(), "base": _build.load(_build.build(csrc=base_csrc), False)}
    for name in _build._SIGNATURES:
        if name.endswith("_smem_bytes") and not hasattr(libs["base"], name):
            setattr(libs["base"], name, getattr(libs["new"], name))
    gen = torch.Generator(dev).manual_seed(0)
    differ, failures, sums = [], [], {}

    def in_turns(calls, a):
        """Times of calls[build](a), base, new, new, base."""
        ms = {"base": [], "new": []}
        for which in ("base", "new", "new", "base"):
            _build._lib = libs[which]
            ms[which].append(time_ms(lambda: calls[which](a)))
        return ms

    def record(kernel, label, ms, **extra):
        print(json.dumps({"kernel": kernel, "shape": label, **extra,
                          **{f"{w}_ms": v for w, v in ms.items()},
                          "new_over_base": float(np.mean(ms["new"]) / np.mean(ms["base"]))}),
              flush=True)
        tot = sums.setdefault(kernel, {"base_ms": 0.0, "new_ms": 0.0})
        for w, v in ms.items():
            tot[f"{w}_ms"] += float(np.mean(v))

    def outputs(calls, a):
        """Each build's outputs of calls[build](a)."""
        outs = {}
        for which, lib in libs.items():
            _build._lib = lib
            outs[which] = _tuple(calls[which](a))
        return outs

    def equal(outs):
        return all(torch.equal(u, v) for u, v in zip(outs["base"], outs["new"]))

    def same_in(calls, a, dtypes):
        return {dt: equal(outputs(calls, a.to(dt))) for dt in dtypes}

    def held(kernel, label, calls, plains, a, kind):
        """Each build's bf16 readings against the plain version; failures
        are collected."""
        readings = {}
        for which, lib in libs.items():
            _build._lib = lib
            readings[which], failed = bf16_check(calls[which], plains[which], a, kind)
            failures.extend(f"{which} build {kernel} [{label}] {f}" for f in failed)
        return readings

    both = (torch.float32, torch.bfloat16)
    for kernel, label, x3, call, plain, kind in _redesigned_fwd_calls(dev, gen):
        calls = {w: call for w in libs}
        same = same_in(calls, x3, both)
        readings = held(kernel, label, calls, {w: plain for w in libs}, x3, kind)
        record(kernel, label, in_turns(calls, x3.to(torch.bfloat16)),
               fp32_bit_identical=same[torch.float32], bf16_bit_identical=same[torch.bfloat16],
               bf16=readings)
        differ += [] if same[torch.float32] else [f"{kernel} [{label}] fp32"]
    for kernel, label, x3, call, plain, kind in _shared_bwd_calls(dev, gen):
        calls = {w: call for w in libs}
        same = same_in(calls, x3, both)
        readings = held(kernel, label, calls, {w: plain for w in libs}, x3, kind)
        record(kernel, label, in_turns(calls, x3.to(torch.bfloat16)),
               fp32_bit_identical=same[torch.float32], bf16_bit_identical=same[torch.bfloat16],
               bf16=readings)
        differ += [f"{kernel} [{label}] {str(dt)[6:]}" for dt, ok in same.items() if not ok]
    for kernel, label, qkv, calls, kind in _tiled_calls(dev, gen):
        pairs = {w: calls() for w in libs}        # each build's backward from its own stats
        kernel_calls = {w: c for w, (c, _) in pairs.items()}
        same = same_in(kernel_calls, qkv, both)
        readings = held(kernel, label, kernel_calls, {w: pl for w, (_, pl) in pairs.items()}, qkv,
                        kind)
        record(kernel, label, in_turns(kernel_calls, qkv.to(torch.bfloat16)),
               fp32_bit_identical=same[torch.float32], bf16_bit_identical=same[torch.bfloat16],
               bf16=readings)
        differ += [f"{kernel} [{label}] {str(dt)[6:]}" for dt, ok in same.items() if not ok]
    for kernel, label, rows, c, eps, work in _ln_sites():
        x, _, g, bt = _ln_inputs(dev, gen, rows, c)
        if kernel.endswith("_bwd"):
            dy = _bf16_values(torch.randn(rows, c, device=dev, generator=gen))
            call, plain, _ = _ln_bwd_calls(g, dy, eps, c)
        else:
            call, plain, _ = _ln_fwd_calls(g, bt, eps, c)
        kind = "layer_norm_bwd" if kernel.endswith("_bwd") else "layer_norm"
        readings = {}
        for which, lib in libs.items():
            _build._lib = lib
            readings[which], failed = full_check(call, plain, x, kind)
            failures.extend(f"{which} build {kernel} [{label}] {f}" for f in failed)
        record(kernel, label, in_turns({w: call for w in libs}, x.to(work)),
               dtype=str(work)[6:], new_body=ln._ln_body(work, c, kind == "layer_norm_bwd"),
               checks=readings)
        del x, g, bt
    steps = {}
    for label, one_step in _step_calls(dev):
        ms = {"base": [], "new": []}
        for which in ("base", "new"):
            _build._lib = libs[which]
            one_step()                                  # warm-up
        for which in ("base", "new", "new", "base"):
            _build._lib = libs[which]
            for _ in range(STEP_TURNS):
                t0 = time.perf_counter()
                one_step()
                ms[which].append((time.perf_counter() - t0) * 1e3)
        steps[label] = {**{f"{w}_ms_median": float(np.median(v)) for w, v in ms.items()},
                        **{f"{w}_ms": v for w, v in ms.items()}}
        steps[label]["new_minus_base_ms"] = (steps[label]["new_ms_median"]
                                             - steps[label]["base_ms_median"])
        kernel_ms = {"base": [], "new": []}
        for which in ("base", "new", "new", "base"):
            _build._lib = libs[which]
            kernel_ms[which].append(_kernel_ms(one_step))
        for which, kms in kernel_ms.items():
            steps[label][f"{which}_kernel_ms_each"] = kms
            steps[label][f"{which}_kernel_ms"] = float(np.mean(kms))
            steps[label][f"{which}_device_idle_share"] = 1 - np.mean(kms) / steps[label][
                f"{which}_ms_median"]
        print(json.dumps({"step": label, **steps[label]}), flush=True)
        del one_step
        torch.cuda.empty_cache()
    _build._lib = libs["new"]
    for tot in sums.values():
        tot["new_over_base"] = tot["new_ms"] / tot["base_ms"]
    print(json.dumps({"compare_build": str(base_csrc), "per_kernel": sums,
                      "steps": {k: {w: v[w] for w in (
                          "base_ms_median", "new_ms_median", "new_minus_base_ms",
                          "base_kernel_ms", "new_kernel_ms", "base_device_idle_share",
                          "new_device_idle_share")} for k, v in steps.items()}}), flush=True)
    require(not differ, f"outputs differ from the base build: {differ}")
    require(not failures, f"bf16 limits exceeded: {failures}")


def kernels_line(recs, runs):
    """The ``kernels`` line: per kernel, times summed over its main-path
    shapes (one call of each; the records marked off_path are left out of
    the sums, unless the kernel has no other, as the split entries), the
    largest errors over every shape checked, and ``launches``: those of the
    first run in ``runs`` (name -> launch counts of one step or call, in
    order: the 2d_feature step, the pixel step, the swin2d step, the violet
    step, the multiple-choice step, one eval, one multiple-choice eval, the
    3d_feature, 2d_clip and hog steps, the lanebench tool's run) that
    launched the kernel, each run's beside it as ``launches_<name>``."""
    line = []
    for name, meta in KERNELS.items():
        checked = [r for r in recs if r["kernel"] == name]
        mine = [r for r in checked if not r.get("off_path")] or checked
        tot = {k: sum(r[k] for r in mine) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        ops_bound = sum(r["bound_ms"] for r in mine if r["bound_by"] == "operations")
        bf16 = {k: max(r[k] for r in checked if k in r) for k in checked[0]
                if k.startswith(("max_abs_err_bf16", "mismatch_bf16", "over_one_step_bf16",
                                 "share_over_one_step_bf16"))}
        # the window kernels: each shape weighted by its blocks in a step
        step = {f"{k}_step": sum(r[k] * r["launches_per_step"] for r in mine)
                for k in tot} if "launches_per_step" in mine[0] else {}
        # rows 4, 6, 8-11: the body each dtype ran (tensor_core or cuda_core)
        body = {"body": {k: v for r in checked for k, v in r["body"].items()}} if (
            "body" in checked[0]) else {}
        line.append({"name": name, "route": "cuda", **meta,
                     "launches": next((n[name] for n in runs.values() if n.get(name)), 0),
                     **{f"launches_{run}": n.get(name, 0) for run, n in runs.items()},
                     "max_abs_err": max(r["max_abs_err"] for r in checked), **bf16,
                     "ms": tot["ms"], "kernel_ms": tot["ms"], "plain_ms": tot["plain_ms"],
                     "bound_ms": tot["bound_ms"],
                     "bound_by": "operations" if ops_bound > tot["bound_ms"] / 2 else "bytes",
                     "library_ms": tot["library_ms"], **step, **body, "shapes": len(mine),
                     "shapes_checked": len(checked)})
    return line


def _nvidia_smi() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--compare-build", type=Path, metavar="CSRC",
                        help="only compare the redesigned kernels (rows 1-12) with a "
                             "build of CSRC")
    args = parser.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "the port's chip run needs a CUDA card")
    if args.compare_build:
        compare_builds(args.compare_build)
        return
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = _nvidia_smi()
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
            + ln_bwd_cases(dev, gen)
            + lane_window_cases(dev, gen) + ln_cases(dev, gen, TEACHER_LN, "train teacher")
            + lane_window_bwd_cases(dev, gen) + packed_cases(dev, gen)
            + direct_cases(dev, gen, TRAIN_B, TRAIN_T, "violet train", SwinConfig.violet(),
                           (2, 3))
            + direct_bwd_cases(dev, gen, "violet ", SwinConfig.violet(), (2, 3))
            + direct_bwd_cases(dev, gen, "mc ", b=QAMC_B, t=5)
            + tiled_sa_cases(dev, gen)
            + ln_cases(dev, gen, TEACHER3D_LN[len(TEACHER_LN):], "train 3d teacher")
            + clip_lane_case(dev, gen) + ln_cases(dev, gen, CLIP_LN, "train clip teacher")
            + lane_attention_cases(dev, gen) + c128_cases(dev, gen))
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

    # 6. the pretrain train step at full width, MVM-pixel
    run = load_run_config(str(PRETRAIN_CONFIG))
    train_launches = train_phase(dev, run, TRAIN_LAUNCHES)
    torch.cuda.empty_cache()

    # 7. the whole pixel train step, card fp32 against CPU fp32
    whole_step_phase(dev, run)
    torch.cuda.empty_cache()

    # 8. the pretrain train step at full width, MVM-2d_feature (the frozen
    # 2D Swin-base teacher in the loop)
    run_2d = with_mvm_target(run, ("2d_feature",))
    train_2d_launches = train_phase(dev, run_2d, TRAIN_2D_LAUNCHES)
    torch.cuda.empty_cache()

    # 9. the whole 2d_feature train step, card fp32 against CPU fp32
    whole_step_phase(dev, run_2d)
    torch.cuda.empty_cache()

    # 10. the pretrain train step at full width on the trained 2D Swin-base
    # backbone (concat fusion), MVM-pixel
    run_swin2d = with_swin2d_backbone(run)
    train_swin2d_launches = train_phase(dev, run_swin2d, TRAIN_SWIN2D_LAUNCHES)
    torch.cuda.empty_cache()

    # 11. the whole swin2d train step, card fp32 against CPU fp32
    whole_step_phase(dev, run_swin2d)
    torch.cuda.empty_cache()

    # 12. the pretrain train step at full width on the C = 96 Video Swin
    # (vis_backbone_size "violet"), MVM-pixel: the packed kernel in stages 0-1
    run_violet = with_violet_backbone(run)
    train_violet_launches = train_phase(dev, run_violet, TRAIN_VIOLET_LAUNCHES)
    torch.cuda.empty_cache()

    # 13. the whole violet train step, card fp32 against CPU fp32
    whole_step_phase(dev, run_violet)
    torch.cuda.empty_cache()

    # 14. the multiple-choice QA fine-tune step at full width (msrvtt-mc):
    # the fusion over 40 rows of 350 tokens on the tiled self-attention
    run_qamc = load_run_config(str(QAMC_CONFIG))
    train_qamc_launches, qamc_model = qamc_train_phase(dev, run_qamc)
    torch.cuda.empty_cache()

    # 15. the whole multiple-choice step, card fp32 against CPU fp32
    qamc_whole_step_phase(dev, run_qamc)
    torch.cuda.empty_cache()

    # 16. the multiple-choice eval on the trained model
    eval_qamc_launches = qamc_eval_phase(dev, qamc_model, run_qamc)
    del qamc_model
    torch.cuda.empty_cache()

    # 17. the lanebench tool: row 12 against transpose + row 9, and the lane
    # window forward + backward (rows 7-8) against the packed one (rows 9-10)
    lanebench_launches = lanebench_phase()
    torch.cuda.empty_cache()

    # 18-20. the pretrain train step at full width for the 3d_feature (the
    # frozen Video Swin-base teacher), 2d_clip (the frozen CLIP ViT-B/32) and
    # hog MVM targets
    step_launches = {}
    for target, want in (("3d_feature", TRAIN_3D_LAUNCHES), ("2d_clip", TRAIN_CLIP_LAUNCHES),
                         ("hog", TRAIN_HOG_LAUNCHES)):
        step_launches[f"train_step_{target}"] = train_phase(
            dev, with_mvm_target(run, (target,)), want)
        torch.cuda.empty_cache()

    # 21. the whole train step for the three targets together, card fp32
    # against CPU fp32 (the teachers at full depth, one hog target for both)
    whole_step_phase(dev, with_mvm_target(run, ("hog", "3d_feature", "2d_clip")))
    torch.cuda.empty_cache()

    require(not failures, "kernel checks failed:\n" + "\n".join(failures))

    line = kernels_line(recs, {
        "train_step_2d_feature": train_2d_launches, "train_step": train_launches,
        "train_step_swin2d": train_swin2d_launches, "train_step_violet": train_violet_launches,
        "train_step_qamc": train_qamc_launches, "eval": eval_launches,
        "eval_qamc": eval_qamc_launches, **step_launches, "lanebench": lanebench_launches})
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
