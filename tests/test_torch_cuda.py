"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card and skip without one. This file imports no JAX,
so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest`` skips tests/conftest.py, which imports JAX). fp32 runs with
TF32 off and is held to chip_smoke's ``FP32_LIMITS`` (forward attention
atol 1e-4, LayerNorm 1e-5; the backward outputs relative to their largest
value); bf16 is held by ``chip_smoke.bf16_check``, the limits the chip smoke
run holds the kernels to, and the planted-fault tests show what those
limits catch.
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from chip_smoke import (FP32_LIMITS, LARGE_MEAN, OUTPUTS, PLANTED_LN, PLANTED_ROW_STRIDE,
                        PLANTED_SUFFIX_MASK, PLANTED_TILED, ROW_STRIDE_SOURCES, SEQ2SEQ_TILED,
                        SWINBERT_LANE, TEXT_STACK_LANE, _excess, _lane_calls, _lane_fwd_kind,
                        _padding_mask, _sa_calls, _tuple, _window_bwd_kind, _window_fwd_kind,
                        bf16_check, full_check, plant, seq2seq_mask, swinbert_mask)
from empirical_mvm_torch.models.video_swin import _shift_attn_mask
from empirical_mvm_torch.ops import _build
from empirical_mvm_torch.ops import layernorm as tln
from empirical_mvm_torch.ops import window_attention as twa

TOL = {"attention": 1e-4, "layer_norm": 1e-5}   # fp32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rs, *shape, scale=1.0):
    return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32))


def _check(kernel, plain, act, dtype, kind):
    """fp32: kernel against plain at TOL (forward) or chip_smoke's
    FP32_LIMITS (backward); bf16: chip_smoke's bf16 limits."""
    if dtype == torch.float32 and kind in TOL:
        torch.testing.assert_close(kernel(act), plain(act), atol=TOL[kind],
                                   rtol=max(TOL[kind], 1e-5))
    elif dtype == torch.float32:
        for name, out, ref in zip(OUTPUTS[kind], _tuple(kernel(act)), _tuple(plain(act))):
            over = _excess((out - ref).abs(), ref, **FP32_LIMITS[kind][name])
            assert over <= 0, (name, over)
    else:
        readings, failures = bf16_check(kernel, plain, act, kind)
        assert not failures, (failures, readings)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    # (b, d, hp, wp, c, nh, window): the JAX test's shape, and a ragged N=245
    # window of the swin stages at hd=32
    (2, 2, 6, 9, 128, 4, (2, 3, 3)),
    (1, 5, 14, 14, 256, 8, (5, 7, 7)),
])
def test_direct_window_attention_kernel(cuda, dtype, shape):
    b, d, hp, wp, c, nh, win = shape
    rs = np.random.RandomState(0)
    n = win[0] * win[1] * win[2]
    nw = (hp // win[1]) * (wp // win[2])
    x3 = _randn(rs, b, d, hp, wp, 3 * c, scale=0.5).to(cuda)
    bias = _randn(rs, nh, n, n, scale=0.1).to(cuda)
    mask = torch.from_numpy(np.where(rs.rand(nw, n, n) < 0.3, -100.0, 0.0)
                            .astype(np.float32)).to(cuda)
    before = _build.launch_counts["direct_window_attention"]
    for m in (mask, None):
        _check(lambda a: twa.direct_window_attention(a, bias, m, win, nh, (c // nh) ** -0.5),
               lambda a: twa.direct_window_attention_plain(a, bias, m, win, nh,
                                                           (c // nh) ** -0.5),
               x3, dtype, _window_fwd_kind(c // nh, n))
    assert _build.launch_counts["direct_window_attention"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,c,nh", [(4, 24, 128, 4), (3, 275, 768, 12)])
def test_lane_self_attention_kernel(cuda, dtype, b, l, c, nh):
    rs = np.random.RandomState(1)
    x3 = _randn(rs, b, l, 3 * c, scale=0.5).to(cuda)
    keep = np.ones((b, l), np.float32)
    keep[0, l // 2:] = 0
    bias = torch.from_numpy((1.0 - keep) * np.finfo(np.float32).min).to(cuda)
    mask = bias[:, None, :].expand(b, l, l)         # the broadcast view BERT passes
    _check(lambda a: twa.lane_self_attention(a, mask, nh, (c // nh) ** -0.5),
           lambda a: twa.lane_self_attention_plain(a, mask, nh, (c // nh) ** -0.5),
           x3, dtype, _lane_fwd_kind(c // nh))


# LayerNorm shapes (rows, C, eps): the fusion width, the paths' other widths
# (the 2D teacher's 128-2048, each on the vectorized body in bf16; fp32 runs
# it at 768 alone, the scalar body at the others), a ragged row count, C =
# 96 (the scalar body in both dtypes), and the text stack's 20 captions of
# 32 tokens
LN_SHAPES = [(40, 768, 1e-12), (250, 768, 1e-5), (7, 96, 1e-5), (333, 128, 1e-5),
             (300, 256, 1e-5), (300, 512, 1e-5), (130, 1024, 1e-5), (70, 2048, 1e-5),
             (640, 768, 1e-12)]


def _ln_inputs(rs, rows, c, cuda, mean=0.0, std=2.0):
    x = (_randn(rs, rows, c, scale=std) + mean).to(cuda)
    return x, _randn(rs, c, scale=0.1).to(cuda) + 1.0, _randn(rs, c, scale=0.1).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c,eps",
                         LN_SHAPES + [(80 * 197, 1024, 1e-6), (80 * 50, 768, 1e-6)])
def test_fused_layer_norm_kernel(cuda, dtype, rows, c, eps):
    """Each body against the plain version, at the shapes above and at the
    depth teacher's sites (the DPT-Large's 80 frames of 197 tokens of width
    1024, eps 1e-6); in bf16 also at rows of chip_smoke's ``LARGE_MEAN``
    (mean 50, std 1), where a one-pass variance fails."""
    rs = np.random.RandomState(2)
    x, g, bt = _ln_inputs(rs, rows, c, cuda)
    before = _build.launch_counts["fused_layer_norm"]
    _check(lambda a: tln.fused_layer_norm(a, g, bt, eps),
           lambda a: tln.layer_norm_reference(a, g, bt, eps), x, dtype, "layer_norm")
    assert _build.launch_counts["fused_layer_norm"] > before
    assert tln._ln_body(dtype, c) == ("vectorized" if c in tln.VECTOR_WIDTHS[dtype]
                                      else "scalar")
    if dtype == torch.bfloat16:
        large = _ln_inputs(rs, rows, c, cuda, *LARGE_MEAN)[0]
        _check(lambda a: tln.fused_layer_norm(a, g, bt, eps),
               lambda a: tln.layer_norm_reference(a, g, bt, eps), large, dtype, "layer_norm")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 2, 6, 9, 128, 4, (2, 3, 3)),
    (3, 4, 14, 14, 256, 8, (4, 7, 7)),       # N = 196, hd = 32, as in training
])
def test_direct_window_attention_bwd_kernel(cuda, dtype, shape):
    b, d, hp, wp, c, nh, win = shape
    rs = np.random.RandomState(3)
    n = win[0] * win[1] * win[2]
    nw = (hp // win[1]) * (wp // win[2])
    x3 = _randn(rs, b, d, hp, wp, 3 * c, scale=0.5).to(cuda)
    do = _randn(rs, b, d, hp, wp, c).to(cuda).to(torch.bfloat16).float()
    bias = _randn(rs, nh, n, n, scale=0.1).to(cuda)
    mask = torch.from_numpy(np.where(rs.rand(nw, n, n) < 0.3, -100.0, 0.0)
                            .astype(np.float32)).to(cuda)
    scale = (c // nh) ** -0.5
    for m in (mask, None):
        _check(lambda a: twa._direct_bwd(a, bias, m, do.to(a.dtype), win, nh, scale),
               lambda a: twa.direct_window_attention_backward_plain(
                   a, bias, m, do.to(a.dtype), win, nh, scale), x3, dtype, "attention_bwd")
    # through autograd: one forward and one backward launch
    before = dict(_build.launch_counts)
    xg = x3.to(dtype).requires_grad_(True)
    bg = bias.clone().requires_grad_(True)
    twa.direct_window_attention(xg, bg, mask, win, nh, scale).backward(do.to(dtype))
    assert _build.launch_counts["direct_window_attention"] == before.get(
        "direct_window_attention", 0) + 1
    assert _build.launch_counts["direct_window_attention_bwd"] == before.get(
        "direct_window_attention_bwd", 0) + 1
    assert torch.isfinite(xg.grad.float()).all() and torch.isfinite(bg.grad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b_,nh,c,nw", [
    # the teacher's stage 0 in small: 2 clips of 4 frames x 4 windows of
    # 7 x 7 (hd = 32) with the 4-frame mask, and a mask period of 6
    (32, 4, 128, 16),
    (12, 4, 128, 6),
])
def test_lane_window_attention_kernel(cuda, dtype, b_, nh, c, nw):
    rs = np.random.RandomState(7)
    n = 49
    x3 = _randn(rs, b_, n, 3 * c, scale=0.5).to(cuda)
    bias = _randn(rs, nh, n, n, scale=0.1).to(cuda)
    mask = torch.from_numpy(np.where(rs.rand(nw, n, n) < 0.3, -100.0, 0.0)
                            .astype(np.float32)).to(cuda)
    scale = (c // nh) ** -0.5
    before = _build.launch_counts["lane_window_attention"]
    for m, w in ((mask, nw), (None, 1)):
        _check(lambda a: twa.lane_window_attention(a, bias, m, w, nh, scale),
               lambda a: twa.lane_window_attention_reference(a, bias, m, w, nh, scale),
               x3, dtype, _window_fwd_kind(c // nh, n))
    assert _build.launch_counts["lane_window_attention"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b_,nh,c,nw", [
    # lanebench's stages 0 and 2 in small (N = 196, hd = 32), and one mask
    # for every window at hd = 32 and 64
    (32, 4, 128, 16),
    (8, 16, 512, 4),
    (6, 4, 128, 1),
    (6, 2, 128, 1),
])
def test_lane_attention_kernel(cuda, dtype, b_, nh, c, nw):
    """Row 12 (the lanebench tool's kernel: the scale on the fp32 scores)
    against its plain version, with a mask of entries 0 or -100, in bf16
    within the limits of the body it runs (``_window_fwd_kind``: the
    tensor cores at hd 32, attend_row at hd 64)."""
    rs = np.random.RandomState(12)
    n = 196
    x3 = _randn(rs, b_, n, 3 * c, scale=0.5).to(cuda)
    bias = _randn(rs, nh, n, n, scale=0.1).to(cuda)
    mask = torch.from_numpy(np.where(rs.rand(nw, n, n) < 0.3, -100.0, 0.0)
                            .astype(np.float32)).to(cuda)
    scale = (c // nh) ** -0.5
    before = _build.launch_counts["lane_attention"]
    _check(lambda a: twa.lane_attention(a, bias, mask, nh, scale),
           lambda a: twa.lane_attention_reference(a, bias, mask, nh, scale),
           x3, dtype, _window_fwd_kind(c // nh, n))
    assert _build.launch_counts["lane_attention"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b_,nh,c,nw", [
    # the trained 2D swin's stage 0 in small (2 clips of 4 frames x 4
    # windows of 7 x 7, hd = 32, the 4-frame mask) and its stage 3 (one
    # window a frame at C = 1024, nH = 32; a mask period of 2 as well)
    (32, 4, 128, 16),
    (8, 32, 1024, 2),
])
def test_lane_window_attention_bwd_kernel(cuda, dtype, b_, nh, c, nw):
    """The backward kernel against its plain version, shifted and
    unshifted; through autograd one forward and one backward launch; two
    runs give bit-identical dbias (fixed-order sums, no atomics)."""
    rs = np.random.RandomState(8)
    n = 49
    x3 = _randn(rs, b_, n, 3 * c, scale=0.5).to(cuda)
    do = _randn(rs, b_, n, c).to(cuda).to(torch.bfloat16).float()
    bias = _randn(rs, nh, n, n, scale=0.1).to(cuda)
    mask = torch.from_numpy(np.where(rs.rand(nw, n, n) < 0.3, -100.0, 0.0)
                            .astype(np.float32)).to(cuda)
    scale = (c // nh) ** -0.5
    for m, w in ((mask, nw), (None, 1)):
        _check(lambda a: twa._lane_window_bwd(a, bias, m, do.to(a.dtype), w, nh, scale),
               lambda a: twa.lane_window_attention_backward_plain(
                   a, bias, m, do.to(a.dtype), w, nh, scale), x3, dtype, "attention_bwd")
        first = twa._lane_window_bwd(x3.to(dtype), bias, m, do.to(dtype), w, nh, scale)
        second = twa._lane_window_bwd(x3.to(dtype), bias, m, do.to(dtype), w, nh, scale)
        assert torch.equal(first[1], second[1]) and torch.equal(first[0], second[0])
    before = dict(_build.launch_counts)
    xg = x3.to(dtype).requires_grad_(True)
    bg = bias.clone().requires_grad_(True)
    twa.lane_window_attention(xg, bg, mask, nw, nh, scale).backward(do.to(dtype))
    for name in ("lane_window_attention", "lane_window_attention_bwd"):
        assert _build.launch_counts[name] == before.get(name, 0) + 1
    assert torch.isfinite(xg.grad.float()).all() and torch.isfinite(bg.grad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b_,nh,n,nw", [
    # the violet swin's stage 0 in small (2 clips of 4 windows of 4 x 7 x 7,
    # hd = 32) and the 2D Swin-tiny's (2 clips of 4 frames x 4 windows of
    # 7 x 7, the 4-frame mask)
    (8, 3, 196, 4),
    (32, 3, 49, 16),
    # the 2D Swin-tiny's stage 1 (C = 192: 6 heads), 2 clips of 4 frames x 4
    # windows
    (32, 6, 49, 16),
])
def test_packed_window_attention_kernels(cuda, dtype, b_, nh, n, nw):
    """Forward and backward against their plain versions, shifted and
    unshifted; two backward runs give bit-identical outputs (fixed-order
    sums, no atomics); through autograd one forward and one backward
    launch."""
    rs = np.random.RandomState(9)
    qkv = _randn(rs, b_, 3 * nh, n, 32, scale=0.5).to(cuda)
    do = _randn(rs, b_, nh, n, 32).to(cuda).to(torch.bfloat16).float()
    bias = _randn(rs, nh, n, n, scale=0.1).to(cuda)
    mask = torch.from_numpy(np.where(rs.rand(nw, n, n) < 0.3, -100.0, 0.0)
                            .astype(np.float32)).to(cuda)
    scale = 32 ** -0.5
    for m, w in ((mask, nw), (None, 1)):
        _check(lambda a: twa.packed_window_attention(a, bias, m, w, nh, scale),
               lambda a: twa.packed_window_attention_plain(a, bias, m, w, nh, scale),
               qkv, dtype, _window_fwd_kind(32, n))
        _check(lambda a: twa._packed_bwd(a, bias, m, do.to(a.dtype), w, nh, scale),
               lambda a: twa.packed_window_attention_backward_plain(
                   a, bias, m, do.to(a.dtype), w, nh, scale), qkv, dtype, "attention_bwd")
        first = twa._packed_bwd(qkv.to(dtype), bias, m, do.to(dtype), w, nh, scale)
        second = twa._packed_bwd(qkv.to(dtype), bias, m, do.to(dtype), w, nh, scale)
        assert torch.equal(first[1], second[1]) and torch.equal(first[0], second[0])
    before = dict(_build.launch_counts)
    xg = qkv.to(dtype).requires_grad_(True)
    bg = bias.clone().requires_grad_(True)
    twa.packed_window_attention(xg, bg, mask, nw, nh, scale).backward(do.to(dtype))
    for name in ("packed_window_attention", "packed_window_attention_bwd"):
        assert _build.launch_counts[name] == before.get(name, 0) + 1
    assert torch.isfinite(xg.grad.float()).all() and torch.isfinite(bg.grad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_window_attention_kernels(cuda, dtype):
    """Row 10: q, k, v as three arrays on the packed kernel, forward and
    backward against their plain versions at a violet stage-0 shape in
    small (2 clips of 4 shifted windows)."""
    rs = np.random.RandomState(10)
    b_, nh, n, nw = 8, 3, 196, 4
    qkv = _randn(rs, 3, b_, nh, n, 32, scale=0.5).to(cuda)
    do = _randn(rs, b_, nh, n, 32).to(cuda).to(torch.bfloat16).float()
    bias = _randn(rs, nh, n, n, scale=0.1).to(cuda)
    mask = torch.from_numpy(np.where(rs.rand(nw, n, n) < 0.3, -100.0, 0.0)
                            .astype(np.float32)).to(cuda)
    scale = 32 ** -0.5
    before = dict(_build.launch_counts)
    _check(lambda a: twa.fused_window_attention(*a.unbind(0), bias, mask, nw, scale),
           lambda a: twa.fused_window_attention_plain(*a.unbind(0), bias, mask, nw, scale),
           qkv, dtype, _window_fwd_kind(32, n))
    _check(lambda a: twa._fused_bwd(*a.unbind(0), bias, mask, do.to(a.dtype), nw, scale),
           lambda a: twa.fused_window_attention_backward_plain(*a.unbind(0), bias, mask,
                                                               do.to(a.dtype), nw, scale),
           qkv, dtype, "attention_bwd_qkv")
    assert _build.launch_counts["fused_window_attention"] > before.get(
        "fused_window_attention", 0)
    assert _build.launch_counts["packed_window_attention"] == before.get(
        "packed_window_attention", 0)


def _lane_setup(rs, cuda, b, l, c):
    x3 = _randn(rs, b, l, 3 * c, scale=0.5).to(cuda)
    do = _randn(rs, b, l, c).to(cuda).to(torch.bfloat16).float()
    keep = np.ones((b, l), np.float32)
    keep[0, l // 2:] = 0
    bias = torch.from_numpy((1.0 - keep) * np.finfo(np.float32).min).to(cuda)
    return x3, do, bias[:, None, :].expand(b, l, l)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,c,nh", [(4, 24, 128, 4), (3, 232, 768, 12)])
@pytest.mark.parametrize("p_drop", [0.0, 0.1])
def test_lane_self_attention_dropout_and_bwd_kernels(cuda, dtype, b, l, c, nh, p_drop):
    """The forward with dropout and the backward, with the same (seed,
    offset) as the plain versions, element by element."""
    rs = np.random.RandomState(4)
    x3, do, mask = _lane_setup(rs, cuda, b, l, c)
    scale = (c // nh) ** -0.5
    seed = torch.tensor([1234, 5], dtype=torch.int32, device=cuda) if p_drop else None
    if p_drop:
        _check(lambda a: twa._lane_fwd(a, mask, nh, scale, p_drop, seed),
               lambda a: twa.lane_self_attention_plain(a, mask, nh, scale, p_drop, seed),
               x3, dtype, _lane_fwd_kind(c // nh))
    _check(lambda a: twa._lane_bwd(a, mask, do.to(a.dtype), nh, scale, p_drop, seed),
           lambda a: twa.lane_self_attention_backward_plain(a, mask, do.to(a.dtype), nh,
                                                            scale, p_drop, seed),
           x3, dtype, "attention_bwd")


@pytest.mark.cuda
def test_lane_dropout_through_autograd(cuda):
    """The wrapper draws (seed, offset) from the generator on the card, the
    forward counts as a dropout launch, and the backward regenerates the
    forward's mask: the gradient equals the plain backward at that seed."""
    rs = np.random.RandomState(5)
    x3, do, mask = _lane_setup(rs, cuda, 2, 40, 128)
    gen = torch.Generator(cuda).manual_seed(9)
    seed = twa.draw_dropout_seed(torch.Generator(cuda).manual_seed(9))
    before = dict(_build.launch_counts)
    xg = x3.clone().requires_grad_(True)
    twa.lane_self_attention(xg, mask, 4, 32 ** -0.5, 0.1, gen).backward(do)
    for name in ("lane_self_attention_dropout", "lane_self_attention_bwd"):
        assert _build.launch_counts[name] == before.get(name, 0) + 1
    want = twa.lane_self_attention_backward_plain(x3, mask, do, 4, 32 ** -0.5, 0.1, seed)
    assert (xg.grad - want).abs().max() <= 1e-4 * want.abs().max()


def _sa_setup(rs, cuda, b, nh, n, hd):
    """qkv (B, 3nH, N, hd), do (bf16 values), and the (B, N, N) view of a
    (B, 1, N) padding bias that BERT passes (row 0 padded from N / 2)."""
    qkv = _randn(rs, b, 3 * nh, n, hd, scale=0.5).to(cuda)
    do = _randn(rs, b, nh, n, hd).to(cuda).to(torch.bfloat16).float()
    keep = np.ones((b, n), np.float32)
    keep[0, n // 2:] = 0
    bias = torch.from_numpy((1.0 - keep) * np.finfo(np.float32).min).to(cuda)
    return qkv, do, bias[:, None, :].expand(b, n, n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nh,n,hd", [
    # N = 70: a key tile of 6; N = 577, hd = 64: DPT at 384^2, whose fp32
    # heads row 5's shared memory cannot hold; N = 350: the multiple-choice
    # fusion's heads; N = 129: one key in the last tile, at hd = 128 (the
    # columns kernel's blocks of 32 keys)
    (3, 4, 70, 32),
    (2, 16, 577, 64),
    (2, 12, 350, 64),
    (2, 4, 129, 128),
])
@pytest.mark.parametrize("p_drop", [0.0, 0.1])
def test_tiled_self_attention_kernels(cuda, dtype, b, nh, n, hd, p_drop):
    """Row 11 forward and backward against their plain versions, with and
    without dropout (the same (seed, offset)), on the body that dtype and hd
    pick (bf16: the tensor cores at every hd here; fp32: the CUDA cores);
    two runs give bit-identical outputs (no atomics)."""
    rs = np.random.RandomState(11)
    qkv, do, mask = _sa_setup(rs, cuda, b, nh, n, hd)
    scale = hd ** -0.5
    seed = torch.tensor([4321, 3], dtype=torch.int32, device=cuda) if p_drop else None
    if n == 577:
        lib = _build.library()
        assert lib.emvm_attention_smem_bytes(0, n, hd) > _build.MAX_SMEM_BYTES
    (forward, forward_plain, _), (backward, backward_plain, _) = _sa_calls(
        mask, nh, scale, p_drop, seed, do)
    _check(forward, forward_plain, qkv, dtype, "sa")
    _check(backward, backward_plain, qkv, dtype, "sa_bwd")
    a = qkv.to(dtype)
    assert torch.equal(forward(a), forward(a)) and torch.equal(backward(a), backward(a))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("p_drop", [0.0, 0.1])
def test_tiled_columns_p_equals_rows_p(cuda, hd, p_drop):
    """The tensor-core backward's columns kernel forms each p bit for bit as
    the rows of the forward formed it (the rows kernel runs the forward's
    code for p). Read on one tile of 64 keys (j0 ...) and 64 queries (i0 ...)
    through one-hot operands: v[j0 + d, d] = 1 makes out[i, d] the forward's
    rounded p_drop[i, j0 + d]; dO[i0 + d, d] = 1 makes dv[j, d] the columns
    kernel's rounded p_drop[i0 + d, j]. Each is one exact term."""
    rs = np.random.RandomState(21)
    b, nh, n = 2, 3, 350
    qkv, _, mask = _sa_setup(rs, cuda, b, nh, n, hd)
    i0, j0 = 64, 128
    eye = torch.eye(64, hd, device=cuda)
    qkv[:, 2 * nh:] = 0
    qkv[:, 2 * nh:, j0:j0 + 64] = eye
    do = torch.zeros(b, nh, n, hd, device=cuda)
    do[:, :, i0:i0 + 64] = eye
    a = qkv.to(torch.bfloat16)
    seed = torch.tensor([99, 5], dtype=torch.int32, device=cuda) if p_drop else None
    out, stats = twa._packed_sa_fwd(a, mask, nh, hd ** -0.5, p_drop, seed)
    dv = twa._packed_sa_bwd(a, mask, do.to(torch.bfloat16), stats, nh, hd ** -0.5, p_drop,
                            seed)[:, 2 * nh:]
    rows_p = out[:, :, i0:i0 + 64, :64]                      # [i - i0, j - j0]
    cols_p = dv[:, :, j0:j0 + 64, :64].transpose(-1, -2)     # [i - i0, j - j0]
    assert (rows_p != 0).float().mean() > 0.5
    assert torch.equal(rows_p, cols_p)


def _window_bwd_call(caller, n, nh, masked, rs, cuda):
    """The window backward of ``caller`` (direct, lane_window, packed) at
    windows of n tokens (49: (1, 7, 7); 196: (4, 7, 7); 245: (5, 7, 7)),
    nh heads of 32, 2 clips of 4 windows a frame, the shift mask or none:
    (input, kernel call, plain version)."""
    wd = n // 49
    d, hp, nw = wd, 14, 4
    rng = np.random.RandomState(rs)
    bias = _randn(rng, nh, n, n, scale=0.1).to(cuda)
    mask = (torch.from_numpy(_shift_attn_mask((d, hp, hp), (wd, 7, 7), (0, 3, 3))).to(cuda)
            if masked else None)
    c, scale, b = nh * 32, 32 ** -0.5, 2
    if caller == "direct":
        x = _randn(rng, b, d, hp, hp, 3 * c, scale=0.5).to(cuda)
        do = _randn(rng, b, d, hp, hp, c).to(cuda)
        args = (bias, mask, do, (wd, 7, 7), nh, scale)
        return x, twa._direct_bwd, twa.direct_window_attention_backward_plain, args
    w = 1 if mask is None else nw
    if caller == "lane_window":
        x = _randn(rng, b * nw, n, 3 * c, scale=0.5).to(cuda)
        do = _randn(rng, b * nw, n, c).to(cuda)
        return x, twa._lane_window_bwd, twa.lane_window_attention_backward_plain, (
            bias, mask, do, w, nh, scale)
    x = _randn(rng, b * nw, 3 * nh, n, 32, scale=0.5).to(cuda)
    do = _randn(rng, b * nw, nh, n, 32).to(cuda)
    return x, twa._packed_bwd, twa.packed_window_attention_backward_plain, (
        bias, mask, do, w, nh, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("caller", ["direct", "lane_window", "packed"])
@pytest.mark.parametrize("n", [49, 196, 245])
@pytest.mark.parametrize("masked", [True, False])
def test_window_bwd_tensor_core_body(cuda, caller, n, masked):
    """The window backward's tensor-core body (bf16, hd 32) through each of
    its three callers at N = 49, 196 and 245 (none a multiple of 16), with
    and without the shift mask, against the plain version at chip_smoke's
    ``window_bwd_tc`` limits; fp32 (the CUDA-core body) at FP32_LIMITS; dx3
    and dbias bit-identical over two runs (fixed-order sums, no atomics)."""
    x, kernel, plain, args = _window_bwd_call(caller, n, 3, masked, n + masked, cuda)
    assert twa._window_bwd_body(torch.bfloat16, 32) == "tensor_core"

    def run(fn):
        return lambda a: fn(a, args[0], args[1], args[2].to(a.dtype), *args[3:])

    for dtype in (torch.float32, torch.bfloat16):
        _check(run(kernel), run(plain), x, dtype, _window_bwd_kind(32))
    first, second = run(kernel)(x.to(torch.bfloat16)), run(kernel)(x.to(torch.bfloat16))
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.cuda
@pytest.mark.parametrize("p_drop", [0.0, 0.1])
def test_lane_bwd_tensor_core_at_the_train_shape(cuda, p_drop):
    """Row 6 at the train step's fusion shape, 80 rows of L = 232, 12 heads
    of 64, with the stride-0 view of the padding mask, bf16 on row 11's
    tensor-core body, p = 0 and 0.1: within chip_smoke's attention_bwd
    limits; dx3 bit-identical over two runs."""
    rs = np.random.RandomState(14)
    b, l, c, nh = 80, 232, 768, 12
    x3, do, mask = _lane_setup(rs, cuda, b, l, c)
    assert mask.stride(1) == 0 and twa._sa_body(torch.bfloat16, c // nh) == "tensor_core"
    seed = torch.tensor([2026, 9], dtype=torch.int32, device=cuda) if p_drop else None
    scale = (c // nh) ** -0.5

    def kernel(a):
        return twa._lane_bwd(a, mask, do.to(a.dtype), nh, scale, p_drop, seed)

    _check(kernel, lambda a: twa.lane_self_attention_backward_plain(
        a, mask, do.to(a.dtype), nh, scale, p_drop, seed), x3, torch.bfloat16, "attention_bwd")
    a = x3.to(torch.bfloat16)
    assert torch.equal(kernel(a), kernel(a))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lane_fwd_and_bwd_at_the_retrieval_train_shape(cuda, dtype):
    """Rows 5 (with dropout) and 6 at the retrieval fine-tune step's fusion,
    64 rows (8 clips x 8 captions) of L = 275 (no multiple of 16: the
    tensor-core bodies' tail tiles), 12 heads of 64, p = 0.1, the stride-0
    view of the padding mask: within chip_smoke's limits (bf16 on row 11's
    tensor-core bodies, fp32 on the CUDA cores); each output bit-identical
    over two runs."""
    rs = np.random.RandomState(15)
    b, l, c, nh = 64, 275, 768, 12
    x3, do, mask = _lane_setup(rs, cuda, b, l, c)
    seed = torch.tensor([2026, 14], dtype=torch.int32, device=cuda)
    scale = (c // nh) ** -0.5

    def fwd(a):
        return twa._lane_fwd(a, mask, nh, scale, 0.1, seed)

    def bwd(a):
        return twa._lane_bwd(a, mask, do.to(a.dtype), nh, scale, 0.1, seed)

    _check(fwd, lambda a: twa.lane_self_attention_plain(a, mask, nh, scale, 0.1, seed), x3,
           dtype, _lane_fwd_kind(c // nh))
    _check(bwd, lambda a: twa.lane_self_attention_backward_plain(
        a, mask, do.to(a.dtype), nh, scale, 0.1, seed), x3, dtype, "attention_bwd")
    a = x3.to(dtype)
    assert torch.equal(fwd(a), fwd(a)) and torch.equal(bwd(a), bwd(a))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p_drop", [0.0, 0.1])
def test_tiled_self_attention_at_the_generative_mc_shape(cuda, dtype, p_drop):
    """Row 11 forward and backward at the generative multiple choice's
    fusion (tgif-action: 8 rows of 350 tokens, 12 heads of 64), with and
    without dropout, against the plain versions."""
    rs = np.random.RandomState(16)
    qkv, do, mask = _sa_setup(rs, cuda, 8, 12, 350, 64)
    seed = torch.tensor([4321, 4], dtype=torch.int32, device=cuda) if p_drop else None
    (forward, forward_plain, _), (backward, backward_plain, _) = _sa_calls(
        mask, 12, 64 ** -0.5, p_drop, seed, do)
    _check(forward, forward_plain, qkv, dtype, "sa")
    _check(backward, backward_plain, qkv, dtype, "sa_bwd")


@pytest.mark.cuda
@pytest.mark.parametrize("p_drop", [0.0, 0.1])
def test_lane_columns_p_equals_rows_p(cuda, p_drop):
    """Row 6's columns kernel forms each p bit for bit as its rows kernel
    does. The rows kernel runs the tiled forward's code for p from the
    statistics pass (the forward's pass 1), so the tiled forward on the same
    heads, packed, shows the rows' p: with v[j0 + d, d] = 1 its out[i, d] is
    the rounded p_drop[i, j0 + d]; with dO[i0 + d, d] = 1 row 6's dv[j, d] is
    the columns kernel's rounded p_drop[i0 + d, j]. Each is one exact term."""
    rs = np.random.RandomState(22)
    b, l, c, nh = 2, 232, 768, 12
    hd = c // nh
    x3, _, mask = _lane_setup(rs, cuda, b, l, c)
    i0, j0 = 128, 0                      # keys 0-63 are not padded in any row b
    eye = torch.eye(64, hd, device=cuda)
    heads = x3.view(b, l, 3, nh, hd)
    heads[:, :, 2] = 0
    heads[:, j0:j0 + 64, 2] = eye[:, None]
    do = torch.zeros(b, l, nh, hd, device=cuda)
    do[:, i0:i0 + 64] = eye[:, None]
    a = x3.to(torch.bfloat16)
    seed = torch.tensor([99, 5], dtype=torch.int32, device=cuda) if p_drop else None
    packed = a.view(b, l, 3 * nh, hd).transpose(1, 2).contiguous()
    out, _ = twa._packed_sa_fwd(packed, mask, nh, hd ** -0.5, p_drop, seed)
    dx3 = twa._lane_bwd(a, mask, do.reshape(b, l, c).to(torch.bfloat16), nh, hd ** -0.5, p_drop,
                        seed)
    dv = dx3.view(b, l, 3, nh, hd)[:, :, 2].transpose(1, 2)          # (b, nh, l, hd)
    rows_p = out[:, :, i0:i0 + 64, :64]                              # [i - i0, j - j0]
    cols_p = dv[:, :, j0:j0 + 64, :64].transpose(-1, -2)             # [i - i0, j - j0]
    assert (rows_p != 0).float().mean() > 0.5
    assert torch.equal(rows_p, cols_p)


def _window_fwd_call(caller, n, nh, masked, rs, cuda):
    """The window forward of ``caller`` (direct, packed, fused, lane_window,
    lane_attention) at windows of n tokens (49: (1, 7, 7); 196: (4, 7, 7);
    245: (5, 7, 7)), nh heads of 32, 2 clips of 4 windows a frame, the shift
    mask or none (the fused and lane_attention entries, which always add a
    mask: a zero mask of one slot): (input, kernel call, plain version,
    arguments)."""
    wd = n // 49
    d, hp, nw = wd, 14, 4
    rng = np.random.RandomState(rs)
    bias = _randn(rng, nh, n, n, scale=0.1).to(cuda)
    mask = (torch.from_numpy(_shift_attn_mask((d, hp, hp), (wd, 7, 7), (0, 3, 3))).to(cuda)
            if masked else None)
    c, scale, b = nh * 32, 32 ** -0.5, 2
    if caller == "direct":
        x = _randn(rng, b, d, hp, hp, 3 * c, scale=0.5).to(cuda)
        args = (bias, mask, (wd, 7, 7), nh, scale)
        return x, twa._direct_fwd, twa.direct_window_attention_plain, args
    w = 1 if mask is None else nw
    if caller == "packed":
        x = _randn(rng, b * nw, 3 * nh, n, 32, scale=0.5).to(cuda)
        return x, twa._packed_fwd, twa.packed_window_attention_plain, (bias, mask, w, nh, scale)
    if caller == "lane_window":
        x = _randn(rng, b * nw, n, 3 * c, scale=0.5).to(cuda)
        return (x, twa._lane_window_fwd, twa.lane_window_attention_reference,
                (bias, mask, w, nh, scale))
    if caller == "lane_attention":
        x = _randn(rng, b * nw, n, 3 * c, scale=0.5).to(cuda)
        mask = torch.zeros(1, n, n, device=cuda) if mask is None else mask
        return x, twa._lane_attention_fwd, twa.lane_attention_reference, (bias, mask, nh, scale)
    x = _randn(rng, 3, b * nw, nh, n, 32, scale=0.5).to(cuda)
    mask = torch.zeros(1, n, n, device=cuda) if mask is None else mask
    return (x, lambda a, *r: twa._fused_fwd(*a.unbind(0), *r),
            lambda a, *r: twa.fused_window_attention_plain(*a.unbind(0), *r),
            (bias, mask, w, scale))


@pytest.mark.cuda
@pytest.mark.parametrize("caller", ["direct", "packed", "fused", "lane_window",
                                    "lane_attention"])
@pytest.mark.parametrize("n", [49, 196, 245])
@pytest.mark.parametrize("masked", [True, False])
def test_window_fwd_tensor_core_body(cuda, caller, n, masked):
    """The window forward's tensor-core body (bf16, hd 32) through row 3's
    (direct), rows 9-10's (packed, fused), row 7's (lane_window) and row
    12's (lane_attention, the score scale) callers at N = 49, 196 and 245
    (none a multiple of 16), with and without the shift mask, against the
    plain version at chip_smoke's ``window_fwd_tc`` limits; fp32 (the
    CUDA-core body) at FP32_LIMITS; the output bit-identical over two
    runs."""
    x, kernel, plain, args = _window_fwd_call(caller, n, 3, masked, n + masked, cuda)
    assert twa._window_fwd_body(torch.bfloat16, 32, n) == "tensor_core"
    assert _window_fwd_kind(32, n) == "window_fwd_tc"
    for dtype in (torch.float32, torch.bfloat16):
        _check(lambda a: kernel(a, *args), lambda a: plain(a, *args), x, dtype,
               "window_fwd_tc")
    a = x.to(torch.bfloat16)
    assert torch.equal(kernel(a, *args), kernel(a, *args))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["train", "eval", "clip", "dpt"])
@pytest.mark.parametrize("p_drop", [0.0, 0.1])
def test_lane_fwd_tensor_core_at_the_path_shapes(cuda, shape, p_drop):
    """Row 5 at the main paths' shapes (the train step's 80 rows of L = 232,
    the eval's 64 of 275 and the CLIP teacher's 80 of 50, 12 heads of 64;
    the DPT teacher's 80 of 197, 16 heads of 64, whose fp32 holds K and V
    of L = 197 in shared memory), bf16 on row 11's tensor-core forward
    within the ``sa`` limits, fp32 (the CUDA-core kernel) within
    FP32_LIMITS, with and without dropout; the output bit-identical over two
    runs."""
    b, l, c, nh = {"train": (80, 232, 768, 12), "eval": (64, 275, 768, 12),
                   "clip": (80, 50, 768, 12), "dpt": (80, 197, 1024, 16)}[shape]
    x3, _, mask = _lane_setup(np.random.RandomState(l), cuda, b, l, c)
    if shape in ("clip", "dpt"):
        mask = torch.zeros(1, 1, l, device=cuda).expand(b, l, l)
    seed = torch.tensor([2026, 10], dtype=torch.int32, device=cuda) if p_drop else None
    scale = (c // nh) ** -0.5
    assert twa._sa_body(torch.bfloat16, c // nh) == "tensor_core"

    def kernel(a):
        return twa._lane_fwd(a, mask, nh, scale, p_drop, seed)

    for dtype in (torch.float32, torch.bfloat16):
        _check(kernel, lambda a: twa.lane_self_attention_plain(a, mask, nh, scale, p_drop, seed),
               x3, dtype, _lane_fwd_kind(c // nh))
    a = x3.to(torch.bfloat16)
    assert torch.equal(kernel(a), kernel(a))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("p_drop", [0.0, 0.1])
def test_lane_fwd_equals_tiled_fwd(cuda, hd, p_drop):
    """Row 5 is row 11's tensor-core forward in the lane layout: on the same
    heads, rearranged to (B, 3nH, L, hd), with the same mask view and seed,
    row 11's output is row 5's bit for bit (the keep mask from the same
    Philox counter)."""
    b, l, c = 4, 232, 768
    nh = c // hd
    x3, _, mask = _lane_setup(np.random.RandomState(hd), cuda, b, l, c)
    seed = torch.tensor([31, 7], dtype=torch.int32, device=cuda) if p_drop else None
    a = x3.to(torch.bfloat16)
    lane = twa._lane_fwd(a, mask, nh, hd ** -0.5, p_drop, seed)
    packed = a.view(b, l, 3 * nh, hd).transpose(1, 2).contiguous()
    tiled, _ = twa._packed_sa_fwd(packed, mask, nh, hd ** -0.5, p_drop, seed)
    assert torch.equal(lane, tiled.transpose(1, 2).reshape(b, l, c))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_self_attention_through_autograd(cuda, dtype):
    """packed_self_attention and fused_self_attention (the same kernel on q,
    k, v apart) through autograd with dropout: one forward and one backward
    launch each, the split gradients equal the packed dqkv, and the packed
    gradient equals the plain backward at the seed the wrapper drew."""
    rs = np.random.RandomState(12)
    b, nh, n, hd = 2, 4, 100, 64
    qkv, do, mask = _sa_setup(rs, cuda, b, nh, n, hd)
    qkv, do = qkv.to(dtype), do.to(dtype)
    scale = hd ** -0.5
    seed = twa.draw_dropout_seed(torch.Generator(cuda).manual_seed(3))
    before = dict(_build.launch_counts)
    xg = qkv.clone().requires_grad_(True)
    out = twa.packed_self_attention(xg, mask, nh, scale, 0.1, torch.Generator(cuda).manual_seed(3))
    out.backward(do)
    q, k, v = (t.contiguous().requires_grad_(True) for t in qkv.chunk(3, dim=1))
    out2 = twa.fused_self_attention(q, k, v, mask, scale, 0.1,
                                    torch.Generator(cuda).manual_seed(3))
    out2.backward(do)
    for name in ("packed_self_attention", "packed_self_attention_bwd", "fused_self_attention",
                 "fused_self_attention_bwd"):
        assert _build.launch_counts[name] == before.get(name, 0) + 1, name
    assert torch.equal(out, out2)
    assert torch.equal(torch.cat([q.grad, k.grad, v.grad], dim=1), xg.grad)
    want = twa.packed_self_attention_backward_plain(qkv.float(), mask, do.float(), nh, scale, 0.1,
                                                    seed)
    assert (xg.grad.float() - want).abs().max() <= 2e-2 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c,eps", LN_SHAPES + [(4000, 768, 1e-5)])
def test_fused_layer_norm_bwd_kernel(cuda, dtype, rows, c, eps):
    """Each body's backward against the plain version (in bf16 also at the
    ``LARGE_MEAN`` rows); dx, dgamma and dbeta of two runs bit-identical."""
    rs = np.random.RandomState(6)
    x, g, _ = _ln_inputs(rs, rows, c, cuda)
    dy = _randn(rs, rows, c).to(cuda).to(torch.bfloat16).float()
    _check(lambda a: tln._ln_bwd(a, g, dy.to(a.dtype), eps),
           lambda a: tln.layer_norm_backward_reference(a, g, dy.to(a.dtype), eps),
           x, dtype, "layer_norm_bwd")
    if dtype == torch.bfloat16:
        large = _ln_inputs(rs, rows, c, cuda, *LARGE_MEAN)[0]
        _check(lambda a: tln._ln_bwd(a, g, dy.to(a.dtype), eps),
               lambda a: tln.layer_norm_backward_reference(a, g, dy.to(a.dtype), eps),
               large, dtype, "layer_norm_bwd")
    # two runs give bit-identical parameter gradients (no atomics)
    first, second = tln._ln_bwd(x, g, dy, eps), tln._ln_bwd(x, g, dy, eps)
    assert all(torch.equal(u, v) for u, v in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_bwd_bit_identical_at_the_fusion_site(cuda, dtype):
    """dgamma and dbeta at the train fusion site (18,560 rows of 768: 262
    partial rows on the H100) are bit-identical over three runs, and so is
    dx."""
    rs = np.random.RandomState(7)
    x, g, _ = _ln_inputs(rs, 18560, 768, cuda)
    x = x.to(dtype)
    dy = _randn(rs, 18560, 768).to(cuda).to(dtype)
    runs = [tln._ln_bwd(x, g, dy, 1e-12) for _ in range(3)]
    for other in runs[1:]:
        assert all(torch.equal(u, v) for u, v in zip(runs[0], other))


@pytest.mark.cuda
def test_wrappers_raise_on_refused_input(cuda):
    x3 = torch.zeros(1, 2, 6, 9, 3 * 128, device=cuda, dtype=torch.float16)
    bias = torch.zeros(4, 18, 18, device=cuda)
    with pytest.raises(TypeError):                  # fp16 is not a kernel dtype
        twa.direct_window_attention(x3, bias, None, (2, 3, 3), 4, 0.1)
    with pytest.raises(ValueError, match="generator"):  # dropout draws its seed
        twa.lane_self_attention(torch.zeros(1, 8, 3 * 128, device=cuda),
                                torch.zeros(1, 8, 8, device=cuda), 4, 0.1, p_drop=0.1)


# Faults planted in a copy of csrc/ (file, correct text, planted text), each
# a rounding or term of the JAX numerics that a kernel could drop.
PLANTED = {
    "probabilities_not_rounded": ("common.cuh", "sb[j] = to_float(from_float<T>(p));",
                                  "sb[j] = p;"),
    "q_scaled_in_fp32": ("common.cuh",
                         "qb[d] = to_float(from_float<T>(to_float(q_row[d]) * scale_t));",
                         "qb[d] = to_float(q_row[d]) * scale_t;"),
    "bias_dropped": ("window_attention.cu", "bias_h + size_t(t) * n,", "nullptr,"),
    "packed_mask_slot": ("packed_window_attention.cu", "mask + (win % nw) * n * n",
                         "mask + ((win + 1) % nw) * n * n"),
    # the tensor-core body's normalisation moved after P.V (chip_smoke's
    # planted forward fault of row 11, whose forward row 5 runs)
    "tiled_p_rounded_before_normalising": PLANTED_TILED["forward p rounded before normalising"],
    # row 12 with row 7's rounding: q * scale rounded to bf16 (the scores
    # then divided back by the scale that row 12 multiplies them by)
    "row12_q_scaled": ("common.cuh", "qb[d] = to_float(q_row[d]);",
                       "qb[d] = to_float(from_float<T>(to_float(q_row[d]) * scale_t)) / scale_t;"),
    # the same in the tensor-core body's kScoreScale: q * scale rounded to
    # bf16 into the A fragments, the scores then not scaled
    "row12_tc_q_scaled": (
        "attention_fwd_mma.cuh",
        ("qa.r[ks][u] = qw[ks][u];",
         "*sp = make_float2(__fadd_rn(__fmul_rn(sc[nt][2 * r], scale_t), b.x),\n"
         "                              __fadd_rn(__fmul_rn(sc[nt][2 * r + 1], scale_t), b.y));"),
        ("const float2 f =\n"
         "              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qw[ks][u]));\n"
         "          qa.r[ks][u] = sa_mma::pack(f.x * scale_t, f.y * scale_t);",
         "*sp = make_float2(__fadd_rn(sc[nt][2 * r], b.x), __fadd_rn(sc[nt][2 * r + 1], b.y));")),
    # chip_smoke's planted fault of the window forward's tensor-core body
    # (rows 3, 7, 9, 10, 12)
    "window_e_rounded_before_normalising": PLANTED_TILED[
        "window forward e rounded before normalising"],
    # the LayerNorm's vectorized body: the one-pass variance E[x^2] - mean^2
    "ln_one_pass_variance": PLANTED_LN["one-pass variance"],
}
# faults of attend_row (common.cuh) and of the direct kernel's CUDA-core
# call: bf16 runs attend_row in the window forwards (rows 3, 7, 9, 10, 12)
# and the lane self-attention only at a head width that their tensor-core
# bodies do not take, so these are checked there, at hd 48 (whose scale,
# unlike hd 64's 0.125, is inexact in bf16)
ATTEND_ROW_FAULTS = {"probabilities_not_rounded", "q_scaled_in_fp32", "bias_dropped"}
# faults of the packed kernel alone, which the direct kernel does not run
PACKED_ONLY = {"packed_mask_slot"}
# faults of the LayerNorm forward, checked at the train fusion site (18,560
# rows of 768, bf16) at chip_smoke's LARGE_MEAN rows
LN_ONLY = {"ln_one_pass_variance"}
# faults of the tiled self-attention's forward, checked at the
# multiple-choice fusion shape (8 rows of 350, 12 heads, p = 0.1) and, in the
# lane layout of row 5, at the fusion shape
TILED_ONLY = {"tiled_p_rounded_before_normalising"}
# faults that change row 12 (lane_attention), checked at lanebench's stage 2
# in small (16 windows of 196 tokens, 16 heads, nW = 4), at hd 48 for the
# faults of attend_row, else at hd 32 on the tensor-core body; the row12_
# faults change it alone
ROW12_ONLY = {"row12_q_scaled", "row12_tc_q_scaled"}
ROW12_FAULTS = {"probabilities_not_rounded", "window_e_rounded_before_normalising"} | ROW12_ONLY
# faults that also change the lane self-attention at the fusion shape; at hd
# = 64 the scale is 0.125, so q * scale is exact in bf16 and q_scaled_in_fp32
# is no fault there
LANE_FAULTS = {"probabilities_not_rounded"} | TILED_ONLY
# faults that change the lane window kernel (row 7, either body) at the 2D
# teacher's stage 2, hd = 32 (hd 48 for the faults of attend_row)
WINDOW_FAULTS = {"probabilities_not_rounded", "q_scaled_in_fp32", "scale_not_rounded",
                 "window_e_rounded_before_normalising"}
# faults that change the packed kernel (either body, its own mask slot) at
# the violet swin's stage 0 (N = 196, shifted)
PACKED_FAULTS = WINDOW_FAULTS | PACKED_ONLY


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [*PLANTED, "scale_not_rounded"])
def test_bf16_check_catches_planted_faults(cuda, tmp_path, monkeypatch, fault):
    """Each planted fault, built from a copy of the sources, fails the bf16
    limits at a main-path shape (swin stage 2, shifted: N = 245; at hd 32,
    the tensor-core body, or hd 48 for ATTEND_ROW_FAULTS) and, for
    LANE_FAULTS, at the fusion shape (hd 64, row 5 on the tensor cores, or 48
    for ATTEND_ROW_FAULTS); for WINDOW_FAULTS at the 2D teacher's stage 2 (4
    frames of 4 windows of 49 tokens, shifted; the direct case's head
    width); for PACKED_FAULTS at the violet swin's stage 0 (2 clips of 64
    shifted windows of 196 tokens, 3 heads, at the direct case's head width;
    a packed-only fault there alone); for ROW12_FAULTS at lanebench's stage
    2 in small (hd 48 for the faults of attend_row, else 32; a row-12 fault
    there alone); a LayerNorm fault (LN_ONLY) at the train fusion site at
    the large-mean rows alone. The readings are printed (run with -s)."""
    if fault in PLANTED:
        src = tmp_path / "csrc"
        shutil.copytree(_build.CSRC, src)
        plant(src, *PLANTED[fault])
        monkeypatch.setattr(_build, "CSRC", src)
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(_build, "_lib", None)

    def scale_for(a, scale):                # the wrapper's scale, or the fault's
        return scale if fault == "scale_not_rounded" else twa._scale_in(a.dtype, scale)

    gen = torch.Generator(cuda).manual_seed(0)
    hd = 48 if fault in ATTEND_ROW_FAULTS else 32
    win, c, hp = (5, 7, 7), {32: 512, 48: 384}[hd], 14
    nh, n = c // hd, 5 * 7 * 7
    x3 = torch.randn(2, 5, hp, hp, 3 * c, device=cuda, generator=gen) * 0.5
    bias = torch.randn(nh, n, n, device=cuda, generator=gen) * 0.02
    mask = torch.from_numpy(_shift_attn_mask((5, hp, hp), win, (0, 3, 3))).to(cuda)
    scale = hd ** -0.5

    def direct(a):
        lib = _build.library()
        out = torch.empty(a.shape[:-1] + (c,), dtype=a.dtype, device=cuda)
        _build.record_launch(lib.emvm_direct_window_attention_fwd(
            _build.dtype_code(a.dtype), a.data_ptr(), bias.data_ptr(), mask.data_ptr(),
            out.data_ptr(), 2, 5, hp, hp, c, nh, 7, 7, scale_for(a, scale),
            _build.stream_ptr(cuda)), "direct_window_attention")
        return out

    cases = {} if fault in PACKED_ONLY | TILED_ONLY | ROW12_ONLY | LN_ONLY else {"direct": bf16_check(
        direct, lambda a: twa.direct_window_attention_plain(a, bias, mask, win, nh, scale),
        x3, _window_fwd_kind(hd, n))}
    if fault in LANE_FAULTS:
        p, l, d = 16, 275, 768
        lh = 16 if fault in ATTEND_ROW_FAULTS else 12
        xl = torch.randn(p, l, 3 * d, device=cuda, generator=gen) * 0.5
        keep = torch.ones(p, l, device=cuda)
        keep[:, 260:] = 0
        lmask = ((1.0 - keep) * torch.finfo(torch.float32).min)[:, None, :].expand(p, l, l)
        lseed = torch.tensor([78, 3], dtype=torch.int32, device=cuda)
        cases["lane"] = bf16_check(
            lambda a: twa._lane_fwd(a, lmask, lh, (d // lh) ** -0.5, 0.1, lseed),
            lambda a: twa.lane_self_attention_plain(a, lmask, lh, (d // lh) ** -0.5, 0.1, lseed),
            xl, _lane_fwd_kind(d // lh))
    if fault in WINDOW_FAULTS:
        wb, wn, wc = 64, 49, {32: 512, 48: 384}[hd]  # stage 2 of the teacher: nW = 4 x 4
        wh = wc // hd
        wmask = torch.from_numpy(_shift_attn_mask((4, hp, hp), (1, 7, 7), (0, 3, 3))
                                 ).to(cuda)
        xw = torch.randn(wb, wn, 3 * wc, device=cuda, generator=gen) * 0.5
        wbias = torch.randn(wh, wn, wn, device=cuda, generator=gen) * 0.02

        def window(a):
            lib = _build.library()
            out = torch.empty(a.shape[:-1] + (wc,), dtype=a.dtype, device=cuda)
            _build.record_launch(lib.emvm_lane_window_attention_fwd(
                _build.dtype_code(a.dtype), a.data_ptr(), wbias.data_ptr(),
                wmask.data_ptr(), out.data_ptr(), wb, wn, wc, wh, 16,
                scale_for(a, scale), _build.stream_ptr(cuda)), "lane_window_attention")
            return out

        cases["window"] = bf16_check(
            window, lambda a: twa.lane_window_attention_reference(a, wbias, wmask, 16, wh, scale),
            xw, _window_fwd_kind(hd, wn))
    if fault in PACKED_FAULTS:
        xp, pbias, pmask = _packed_setup(gen, cuda, hd)

        def packed(a):
            lib = _build.library()
            out = torch.empty(a.shape[0], 3, 196, hd, dtype=a.dtype, device=cuda)
            seg = a[0, :3].numel() * a.element_size()
            _build.record_launch(lib.emvm_packed_window_attention_fwd(
                _build.dtype_code(a.dtype), a.data_ptr(), a.data_ptr() + seg,
                a.data_ptr() + 2 * seg, a[0].numel(), pbias.data_ptr(), pmask.data_ptr(),
                out.data_ptr(), a.shape[0], 196, 3, hd, 64, scale_for(a, scale),
                _build.stream_ptr(cuda)), "packed_window_attention")
            return out

        cases["packed"] = bf16_check(
            packed, lambda a: twa.packed_window_attention_plain(a, pbias, pmask, 64, 3, scale),
            xp, _window_fwd_kind(hd, 196))
    if fault in TILED_ONLY:
        p, th, tn, thd = 8, 12, 350, 64
        xt, _, mt = _sa_setup(np.random.RandomState(13), cuda, p, th, tn, thd)
        seed = torch.tensor([78, 2], dtype=torch.int32, device=cuda)
        cases["tiled"] = bf16_check(*_sa_calls(mt, th, thd ** -0.5, 0.1, seed, None)[0][:2], xt,
                                    "sa")
    if fault in ROW12_FAULTS:
        rh, rhd = 16, 48 if fault in ATTEND_ROW_FAULTS | {"row12_q_scaled"} else 32
        xr = torch.randn(16, 196, 3 * rh * rhd, device=cuda, generator=gen) * 0.5
        rbias = torch.randn(rh, 196, 196, device=cuda, generator=gen) * 0.1
        rmask = torch.where(torch.rand(4, 196, 196, device=cuda, generator=gen) < 0.3, -100.0,
                            0.0)
        cases["lane_attention"] = bf16_check(
            lambda a: twa.lane_attention(a, rbias, rmask, rh, rhd ** -0.5),
            lambda a: twa.lane_attention_reference(a, rbias, rmask, rh, rhd ** -0.5), xr,
            _window_fwd_kind(rhd, 196))
    if fault in LN_ONLY:
        x, g, bt = _ln_inputs(np.random.RandomState(8), 18560, 768, cuda, *LARGE_MEAN)
        cases["layer_norm"] = bf16_check(lambda a: tln.fused_layer_norm(a, g, bt, 1e-12),
                                         lambda a: tln.layer_norm_reference(a, g, bt, 1e-12), x,
                                         "layer_norm")
    for case, (readings, failures) in cases.items():
        print(f"planted {fault} [{case}]: {readings} failures={failures}")
        assert failures, f"planted fault {fault} passes the bf16 limits at {case}"


def _packed_setup(gen, cuda, hd=32):
    """qkv, bias and mask of the violet swin's stage 0, shifted, for 2
    clips: (128, 9, 196, hd), 3 heads, nW = 64."""
    qkv = torch.randn(128, 9, 196, hd, device=cuda, generator=gen) * 0.5
    bias = torch.randn(3, 196, 196, device=cuda, generator=gen) * 0.02
    mask = torch.from_numpy(_shift_attn_mask((4, 56, 56), (4, 7, 7), (0, 3, 3))).to(cuda)
    return qkv, bias, mask


# Faults planted in the backward kernels: the rounding of ds before its
# products, of p before dv, and the scale on dq (`_direct_bwd_kernel`
# :1499-1501, `_lane_bwd_kernel` :897-906, `_lane_sa_bwd_kernel`
# :1173-1175). bf16 runs the CUDA-core bodies (attention_bwd.cuh,
# self_attention.cu) only at a head width the tensor-core bodies do not take,
# so their faults are checked there (hd 64 for the window backwards, 48 for
# the lane self-attention); the faults in attention_bwd.cuh change the
# direct, the lane window and the packed backward, which share its body, and
# all three must catch them. The tensor-core bodies' faults are checked at
# the path's head widths (hd 32 for the windows, 64 for row 6).
PLANTED_BWD = {
    "direct_ds_not_rounded": ("attention_bwd.cuh", "rb[j] = to_float(from_float<T>(ds));",
                              "rb[j] = ds;"),
    "direct_dq_scale_dropped": ("attention_bwd.cuh",
                                "dq[e] = from_float<T>(acc * scale_f);",
                                "dq[e] = from_float<T>(acc);"),
    "window_p_not_rounded": ("attention_bwd.cuh", "ra[i] = to_float(from_float<T>(p));",
                             "ra[i] = p;"),
    "lane_ds_not_rounded": ("self_attention.cu",
                            "sm.rb[j] = to_float(from_float<T>(sm.ra[j] * (sm.rb[j] - dsum)));",
                            "sm.rb[j] = sm.ra[j] * (sm.rb[j] - dsum);"),
    "lane_dq_scale_dropped": ("self_attention.cu", "dq[e] = from_float<T>(acc * scale_f);",
                              "dq[e] = from_float<T>(acc);"),
    # k, v and their gradients addressed with dout's window stride (the
    # packed kernel's `addr`, which both window bodies take)
    "packed_kv_dout_stride": ("packed_window_attention.cu", "return seg == 3 ?",
                              "return seg >= 1 ?"),
    # the tensor-core body of row 11 (and row 6): dk from q as stored, the
    # scale on the fp32 product (chip_smoke's planted backward fault), and
    # dq's scale dropped
    "tiled_dk_q_scale_not_rounded": PLANTED_TILED["backward q * scale not rounded before dk"],
    "tiled_dq_scale_dropped": ("self_attention_mma.cuh",
                               "pack(acc[dt][2 * r] * scale_f, acc[dt][2 * r + 1] * scale_f)",
                               "pack(acc[dt][2 * r], acc[dt][2 * r + 1])"),
    # chip_smoke's planted faults of the window backward's tensor-core body
    # and of row 6
    "window_ds_rounded_into_dbias": PLANTED_TILED["window backward ds rounded before dbias"],
    "lane_keep_dropped_in_rows": PLANTED_TILED[
        "lane backward keep mask dropped from dp in the rows kernel"],
    # the LayerNorm backward: the m2 term dropped from dx, and the first
    # partial row left out of dgamma and dbeta
    "ln_m2_dropped": PLANTED_LN["m2 dropped from dx"],
    "ln_partial_missing": PLANTED_LN["first partial left out of dgamma and dbeta"],
}
# the faults checked at the lane self-attention's shape too
LANE_BWD_FAULTS = {"lane_ds_not_rounded", "lane_dq_scale_dropped", "tiled_dq_scale_dropped",
                   "lane_keep_dropped_in_rows"}


@pytest.mark.cuda
@pytest.mark.parametrize("fault", list(PLANTED_BWD))
def test_bf16_check_catches_planted_backward_faults(cuda, tmp_path, monkeypatch, fault):
    """Each planted backward fault, built from a copy of the sources, fails
    chip_smoke's bf16 backward limits at a train-path shape, on the body
    that runs it: a window fault at swin stage 2, shifted (N = 196, the
    direct backward), at the trained 2D swin's stage 2 (lane window, 4
    frames of 4 windows of 49 tokens, shifted) and at the violet swin's
    stage 0 (the packed backward, where a fault of the packed kernel alone
    is planted); a lane fault at the fusion shape L = 232 with dropout; a
    fault of the tiled self-attention's tensor-core body at the
    multiple-choice rows (N = 350) with 24 heads of 32, p = 0.1; a LayerNorm
    fault at the train fusion site (18,560 rows of 768), held to the fp32
    and the bf16 limits. The readings are printed (run with -s)."""
    name = PLANTED_BWD[fault][0]
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    plant(src, *PLANTED_BWD[fault])
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    gen = torch.Generator(cuda).manual_seed(0)
    cases = {}
    window_hd = 64 if name == "attention_bwd.cuh" else 32
    if name in ("attention_bwd.cuh", "attention_bwd_mma.cuh", "packed_window_attention.cu"):
        ph = 3                                       # the violet stage 0's heads
        xp = torch.randn(128, 3 * ph, 196, window_hd, device=cuda, generator=gen) * 0.5
        pbias = torch.randn(ph, 196, 196, device=cuda, generator=gen) * 0.02
        pmask = _packed_setup(gen, cuda)[2]
        dp = torch.randn(128, ph, 196, window_hd, device=cuda, generator=gen).to(torch.bfloat16)
        pscale = window_hd ** -0.5
        cases["packed"] = bf16_check(
            lambda a: twa._packed_bwd(a, pbias, pmask, dp.to(a.dtype), 64, ph, pscale),
            lambda a: twa.packed_window_attention_backward_plain(a, pbias, pmask, dp.to(a.dtype),
                                                                 64, ph, pscale),
            xp, _window_bwd_kind(window_hd))
    if name in ("attention_bwd.cuh", "attention_bwd_mma.cuh"):
        win, c, hp = (4, 7, 7), 512, 14
        nh = c // window_hd
        x3 = torch.randn(2, 4, hp, hp, 3 * c, device=cuda, generator=gen) * 0.5
        do = torch.randn(2, 4, hp, hp, c, device=cuda, generator=gen).to(torch.bfloat16)
        bias = torch.randn(nh, 196, 196, device=cuda, generator=gen) * 0.02
        mask = torch.from_numpy(_shift_attn_mask((4, hp, hp), win, (0, 3, 3))).to(cuda)
        scale = window_hd ** -0.5
        cases["direct"] = bf16_check(
            lambda a: twa._direct_bwd(a, bias, mask, do.to(a.dtype), win, nh, scale),
            lambda a: twa.direct_window_attention_backward_plain(a, bias, mask, do.to(a.dtype),
                                                                 win, nh, scale),
            x3, _window_bwd_kind(window_hd))
        wb, wn = 64, 49                              # stage 2 of the 2D swin: nW = 4 x 4
        wmask = torch.from_numpy(_shift_attn_mask((4, hp, hp), (1, 7, 7), (0, 3, 3))
                                 ).to(cuda)
        xw = torch.randn(wb, wn, 3 * c, device=cuda, generator=gen) * 0.5
        dw = torch.randn(wb, wn, c, device=cuda, generator=gen).to(torch.bfloat16)
        wbias = torch.randn(nh, wn, wn, device=cuda, generator=gen) * 0.02
        cases["lane_window"] = bf16_check(
            lambda a: twa._lane_window_bwd(a, wbias, wmask, dw.to(a.dtype), 16, nh, scale),
            lambda a: twa.lane_window_attention_backward_plain(a, wbias, wmask, dw.to(a.dtype),
                                                               16, nh, scale),
            xw, _window_bwd_kind(window_hd))
    if name == "self_attention_mma.cuh":
        # hd 32, where the scale (and so q * scale) rounds in bf16
        p, nh, n, hd = 8, 24, 350, 32
        xt, _, mt = _sa_setup(np.random.RandomState(13), cuda, p, nh, n, hd)
        dt = torch.randn(p, nh, n, hd, device=cuda, generator=gen).to(torch.bfloat16)
        seed = torch.tensor([78, 2], dtype=torch.int32, device=cuda)
        cases["tiled"] = bf16_check(*_sa_calls(mt, nh, hd ** -0.5, 0.1, seed, dt)[1][:2], xt,
                                    "sa_bwd")
    if fault in LANE_BWD_FAULTS:
        # the CUDA-core body at hd 48, the tensor-core body at BERT's hd 64
        p, l, d = 8, 232, 768
        lh = 16 if name == "self_attention.cu" else 12
        x3 = torch.randn(p, l, 3 * d, device=cuda, generator=gen) * 0.5
        do = torch.randn(p, l, d, device=cuda, generator=gen).to(torch.bfloat16)
        keep = torch.ones(p, l, device=cuda)
        keep[:, 220:] = 0
        lmask = ((1.0 - keep) * torch.finfo(torch.float32).min)[:, None, :].expand(p, l, l)
        seed = torch.tensor([77, 1], dtype=torch.int32, device=cuda)
        scale = (d // lh) ** -0.5
        cases["lane"] = bf16_check(
            lambda a: twa._lane_bwd(a, lmask, do.to(a.dtype), lh, scale, 0.1, seed),
            lambda a: twa.lane_self_attention_backward_plain(a, lmask, do.to(a.dtype), lh,
                                                             scale, 0.1, seed),
            x3, "attention_bwd")
    if name == "layer_norm.cu":
        rs = np.random.RandomState(9)
        x, g, _ = _ln_inputs(rs, 18560, 768, cuda)
        dy = _randn(rs, 18560, 768).to(cuda).to(torch.bfloat16)
        cases["layer_norm"] = full_check(
            lambda a: tln._ln_bwd(a, g, dy.to(a.dtype), 1e-12),
            lambda a: tln.layer_norm_backward_reference(a, g, dy.to(a.dtype), 1e-12), x,
            "layer_norm_bwd")
    assert cases
    for case, (readings, failures) in cases.items():
        print(f"planted {fault} [{case}]: {readings} failures={failures}")
        assert failures, f"planted fault {fault} passes the bf16 backward limits at {case}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,text,p_drop", [
    (8, 275, 25, 0.1),       # the caption step
    (8, 270, 20, 0.0),       # greedy decoding at max_len 20 (beam search: 32 rows)
    (20, 232, 32, 0.1),      # the smtm fusion of the pretrain step
])
def test_lane_fwd_and_bwd_under_the_seq2seq_mask(cuda, dtype, b, l, text, p_drop):
    """Rows 5 and 6 under the seq2seq joint mask (``chip_smoke.seq2seq_mask``:
    the port's ``joint_attn_bias``, (B, L, L) with rows that differ, a
    query-row stride of L) at the caption, decode and smtm shapes, against
    their plain versions: fp32 within FP32_LIMITS, bf16 within chip_smoke's
    limits; each output bit-identical over two runs. Video rows mask the
    whole text block and early text rows the later text keys, so whole key
    tiles are masked for some rows; every row sees the video keys of the
    first tile, so none is wholly masked."""
    gen = torch.Generator(cuda).manual_seed(l)
    mask = seq2seq_mask(cuda, b, l, text)
    assert mask.stride(1) == l and not torch.equal(mask[:, 0], mask[:, -1])
    x3 = torch.randn(b, l, 3 * 768, device=cuda, generator=gen) * 0.5
    do = torch.randn(b, l, 768, device=cuda, generator=gen).to(torch.bfloat16).float()
    seed = torch.tensor([2026, 17], dtype=torch.int32, device=cuda) if p_drop else None
    (fwd, fwd_plain, _), (bwd, bwd_plain, _) = _lane_calls(mask, 12, 0.125, p_drop, seed, do)
    _check(fwd, fwd_plain, x3, dtype, _lane_fwd_kind(64))
    _check(bwd, bwd_plain, x3, dtype, "attention_bwd")
    a = x3.to(dtype)
    assert torch.equal(fwd(a), fwd(a)) and torch.equal(bwd(a), bwd(a))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_fwd_and_bwd_under_the_seq2seq_mask(cuda, dtype):
    """Row 11 (the tiled self-attention, kTiles layout) under the seq2seq
    joint mask at ``SEQ2SEQ_TILED``'s length, which
    ``lane_sa_attention_fits`` refuses: forward and backward with dropout
    against their plain versions, fp32 within TOL / FP32_LIMITS, bf16
    within chip_smoke's limits; each output bit-identical over two runs."""
    _, b, l, text, p_drop = SEQ2SEQ_TILED[0]
    assert not twa.lane_sa_attention_fits(b, l, 768, 12)
    gen = torch.Generator(cuda).manual_seed(l)
    mask = seq2seq_mask(cuda, b, l, text)
    assert mask.stride(1) == l and not torch.equal(mask[:, 0], mask[:, -1])
    qkv = torch.randn(b, 36, l, 64, device=cuda, generator=gen) * 0.5
    do = torch.randn(b, 12, l, 64, device=cuda, generator=gen).to(torch.bfloat16).float()
    seed = torch.tensor([2026, 18], dtype=torch.int32, device=cuda)
    (fwd, fwd_plain, _), (bwd, bwd_plain, _) = _sa_calls(mask, 12, 0.125, p_drop, seed, do)
    _check(fwd, fwd_plain, qkv, dtype, "sa")
    _check(bwd, bwd_plain, qkv, dtype, "sa_bwd")
    a = qkv.to(dtype)
    assert torch.equal(fwd(a), fwd(a))
    assert all(torch.equal(x, y) for x, y in zip(_tuple(bwd(a)), _tuple(bwd(a))))


@pytest.mark.cuda
def test_planted_row_stride_fault_fails_only_under_the_seq2seq_mask(cuda, tmp_path,
                                                                    monkeypatch):
    """A copy of the self-attention sources whose C entries pass a query-row
    stride of 0 (``PLANTED_ROW_STRIDE``): under the seq2seq mask rows 5, 6
    and 11 fail the fp32 and the bf16 limits; under a padding mask (a
    stride-0 view, every row alike), the masks of the earlier paths, the
    same build passes, which is why those paths could not show the fault.
    The readings are printed (run with -s)."""
    src = tmp_path / "csrc"
    src.mkdir()
    for name in ROW_STRIDE_SOURCES:
        shutil.copy(_build.CSRC / name, src / name)
    for fault in PLANTED_ROW_STRIDE:
        plant(src, *fault)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", _build.load(_build.build(csrc=src), False))
    gen = torch.Generator(cuda).manual_seed(5)
    b, l, text = 4, 275, 25
    x3 = torch.randn(b, l, 3 * 768, device=cuda, generator=gen) * 0.5
    do = torch.randn(b, l, 768, device=cuda, generator=gen).to(torch.bfloat16).float()
    seed = torch.tensor([79, 4], dtype=torch.int32, device=cuda)
    _, _, n, t_text, _ = SEQ2SEQ_TILED[0]
    qkv = torch.randn(2, 36, n, 64, device=cuda, generator=gen) * 0.5
    t_do = torch.randn(2, 12, n, 64, device=cuda, generator=gen).to(torch.bfloat16).float()
    for kind, mask, t_mask in (
            ("seq2seq", seq2seq_mask(cuda, b, l, text), seq2seq_mask(cuda, 2, n, t_text)),
            ("padding", _padding_mask(cuda, gen, b, l, text, 6),
             _padding_mask(cuda, gen, 2, n, t_text, 6))):
        (fwd, fwd_plain, _), (bwd, bwd_plain, _) = _lane_calls(mask, 12, 0.125, 0.1, seed, do)
        (t_fwd, t_fwd_plain, _), (t_bwd, t_bwd_plain, _) = _sa_calls(t_mask, 12, 0.125, 0.1,
                                                                     seed, t_do)
        for row, kernel, plain, act, limits in (
                ("row 5", fwd, fwd_plain, x3, _lane_fwd_kind(64)),
                ("row 6", bwd, bwd_plain, x3, "attention_bwd"),
                ("row 11", t_fwd, t_fwd_plain, qkv, "sa"),
                ("row 11 bwd", t_bwd, t_bwd_plain, qkv, "sa_bwd")):
            readings, failures = full_check(kernel, plain, act, limits)
            print(f"planted row stride 0 [{row}, {kind} mask]: {readings} failures={failures}")
            if kind == "padding":
                assert not failures, (row, failures)
            else:
                assert any(" fp32 max err" in f for f in failures), row
                assert any(" bf16" in f for f in failures), row


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lane_kernels_at_the_text_stack_shape(cuda, dtype):
    """Rows 5 (p = 0.1) and 6 at the text stack's shape, 20 captions of 32
    tokens under their padding mask (BERT-base heads): fewer keys than one
    64-key tile, two 16-row tiles of queries; against their plain versions."""
    b, l, text = TEXT_STACK_LANE
    gen = torch.Generator(cuda).manual_seed(32)
    mask = _padding_mask(cuda, gen, b, l, text, 6)
    x3 = torch.randn(b, l, 3 * 768, device=cuda, generator=gen) * 0.5
    do = torch.randn(b, l, 768, device=cuda, generator=gen).to(torch.bfloat16).float()
    seed = torch.tensor([2026, 20], dtype=torch.int32, device=cuda)
    (fwd, fwd_plain, _), (bwd, bwd_plain, _) = _lane_calls(mask, 12, 0.125, 0.1, seed, do)
    _check(fwd, fwd_plain, x3, dtype, _lane_fwd_kind(64))
    _check(bwd, bwd_plain, x3, dtype, "attention_bwd")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,kind", [(0, "seq2seq"), (0, "full"), (1, "seq2seq")])
def test_lane_fwd_and_bwd_under_the_swinbert_masks(cuda, dtype, case, kind):
    """Rows 5 and 6 under the SwinBERT masks (``chip_smoke.swinbert_mask``:
    each frame's first video key masked, the fake CLS) at the caption
    step's shape (p = 0.1; ``seq2seq``, and ``full`` with padded captions)
    and the greedy decoder's (p = 0, forward only); against their plain
    versions, each output bit-identical over two runs."""
    label, b, l, text, p_drop, _ = SWINBERT_LANE[case]
    gen = torch.Generator(cuda).manual_seed(l)
    mask = swinbert_mask(cuda, gen, b, l, text, kind)
    assert (mask[:, :, ::50][:, :, :(l - text) // 50] < 0).all()
    x3 = torch.randn(b, l, 3 * 768, device=cuda, generator=gen) * 0.5
    do = torch.randn(b, l, 768, device=cuda, generator=gen).to(torch.bfloat16).float()
    seed = torch.tensor([2026, 21], dtype=torch.int32, device=cuda) if p_drop else None
    (fwd, fwd_plain, _), (bwd, bwd_plain, _) = _lane_calls(mask, 12, 0.125, p_drop, seed, do)
    _check(fwd, fwd_plain, x3, dtype, _lane_fwd_kind(64))
    a = x3.to(dtype)
    assert torch.equal(fwd(a), fwd(a))
    if p_drop:
        _check(bwd, bwd_plain, x3, dtype, "attention_bwd")
        assert torch.equal(bwd(a), bwd(a))


@pytest.mark.cuda
def test_planted_suffix_mask_fault_fails_only_under_the_swinbert_masks(cuda, tmp_path,
                                                                      monkeypatch):
    """A copy of the self-attention sources whose tensor-core body reads each
    row's mask as suffix padding (``PLANTED_SUFFIX_MASK``): under a padding
    mask and the seq2seq one, whose rows allow a prefix of the keys, rows 5
    and 6 pass the bf16 limits; under the SwinBERT masks, with a hole at
    each frame's first key, they fail them. The readings are printed (run
    with -s)."""
    src = tmp_path / "csrc"
    src.mkdir()
    for name in ROW_STRIDE_SOURCES:
        shutil.copy(_build.CSRC / name, src / name)
    plant(src, *PLANTED_SUFFIX_MASK)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", _build.load(_build.build(csrc=src), False))
    gen = torch.Generator(cuda).manual_seed(6)
    b, l, text = 4, 275, 25
    x3 = torch.randn(b, l, 3 * 768, device=cuda, generator=gen) * 0.5
    do = torch.randn(b, l, 768, device=cuda, generator=gen).to(torch.bfloat16).float()
    seed = torch.tensor([81, 6], dtype=torch.int32, device=cuda)
    for kind, mask in (("padding", _padding_mask(cuda, gen, b, l, text, 6)),
                       ("seq2seq", seq2seq_mask(cuda, b, l, text)),
                       ("swinbert full", swinbert_mask(cuda, gen, b, l, text, "full")),
                       ("swinbert seq2seq", swinbert_mask(cuda, gen, b, l, text, "seq2seq"))):
        (fwd, fwd_plain, _), (bwd, bwd_plain, _) = _lane_calls(mask, 12, 0.125, 0.1, seed, do)
        for row, kernel, plain, limits in (("row 5", fwd, fwd_plain, _lane_fwd_kind(64)),
                                           ("row 6", bwd, bwd_plain, "attention_bwd")):
            readings, failures = bf16_check(kernel, plain, x3, limits)
            print(f"planted suffix mask [{row}, {kind} mask]: {readings} failures={failures}")
            assert bool(failures) == kind.startswith("swinbert"), (row, kind, failures)


# ---------------------------------------------------------------------------
# the data layer: nvJPEG, the transform executor, the device stage


def _fixture():
    from empirical_mvm_torch.tools.jpeg_fixture import load_fixture
    return load_fixture()


@pytest.mark.cuda
def test_nvjpeg_decodes_the_fixture_within_its_limits(cuda):
    """nvJPEG against the committed cv2 decode: the largest and the mean
    absolute difference of each frame within the fixture's limits (the
    IDCT's rounding and the 4:2:0 chroma upsampling)."""
    from empirical_mvm_torch.data.jpeg import NvJpegDecoder, decode_counts, jpeg_size
    fx = _fixture()
    dec = NvJpegDecoder(cuda)
    before = decode_counts["nvjpeg_frames"]
    out = dec.decode(fx["frames"], [jpeg_size(f) for f in fx["frames"]])
    torch.cuda.synchronize()
    assert decode_counts["nvjpeg_frames"] == before + len(fx["frames"])
    for o, ref in zip(out, fx["decode"]):
        assert o.is_cuda and o.dtype == torch.uint8 and o.shape == ref.shape
        d = np.abs(o.cpu().numpy().astype(np.int16) - ref)
        assert d.max() <= fx["limit_max_abs"] and d.mean() <= fx["limit_mean_abs"], \
            (d.max(), d.mean())
    dec.close()


@pytest.mark.cuda
@pytest.mark.parametrize("transform", ["pad_resize", "img_center_crop", "img_rand_crop",
                                       "vid_rand_crop"])
@pytest.mark.parametrize("normalize", [False, True])
def test_device_executor_matches_the_cpu_executor(cuda, transform, normalize):
    import random
    from empirical_mvm_torch.data.transforms import plan_clip, run_plans
    fx = _fixture()
    frames = [torch.from_numpy(r) for r in fx["decode"][:4]]
    plan = plan_clip(fx["frames"][:4], [(256, 340)] * 4, 224, "train", transform,
                     random.Random(3), normalize)
    got = run_plans([plan], [[f.to(cuda) for f in frames]], cuda).cpu()
    want = run_plans([plan], [frames], "cpu")
    step = 1.0 / 255.0 / 0.224 + 1e-6 if normalize else 1
    assert got.dtype == want.dtype and got.shape == want.shape == (1, 4, 224, 224, 3)
    assert (got.double() - want.double()).abs().max() <= step


@pytest.mark.cuda
def test_failed_decode_marks_the_item_corrupt(cuda):
    """A frame whose header parses but whose stream stops there, and one
    whose header gives another size than planned: their items come back
    zeroed and ``corrupt``, the batch's other item decoded."""
    import random
    from empirical_mvm_torch.data.jpeg import NvJpegDecoder
    from empirical_mvm_torch.data.loader import materialize
    from empirical_mvm_torch.data.transforms import FramePlan, plan_clip
    fx = _fixture()
    f = fx["frames"][0]
    sof = f.index(b"\xff\xc0")
    cut = f[:sof + 2 + int.from_bytes(f[sof + 2:sof + 4], "big")]
    good = plan_clip(fx["frames"][:2], [(256, 340)] * 2, 224, "train", "img_rand_crop",
                     random.Random(0), False)
    bad = dataclasses.replace(good, frames=(f, cut))
    wrong = dataclasses.replace(good, ops=(FramePlan((128, 340), (0, 0, 0, 0), (224, 298),
                                                     (0, 0, 224, 224)),) * 2)
    dec = NvJpegDecoder(cuda)
    out = materialize({"img": [good, bad, wrong], "txt": np.ones((3, 4), np.int32),
                       "corrupt": np.zeros(3, bool),
                       "on_corrupt": [{"txt": np.zeros(4, np.int32)}] * 3}, dec, cuda)
    assert out["corrupt"].tolist() == [False, True, True]
    assert out["img"][0].any() and not out["img"][1:].any()
    assert out["txt"].tolist() == [[1] * 4, [0] * 4, [0] * 4]
    dec.close()


@pytest.mark.cuda
def test_prefetcher_batches_equal_the_cpu_batches(cuda, tmp_path):
    """The pretrain layout through ``DevicePrefetcher`` on the card against
    the same loader's batches on the CPU, whose decode function is nvJPEG's
    own decode brought to the host: equal text, vq and flags, clips within
    one uint8 step (the executors' resizes)."""
    from empirical_mvm_torch.core.config import load_run_config
    from empirical_mvm_torch.data.jpeg import NvJpegDecoder
    from empirical_mvm_torch.data.loader import DevicePrefetcher
    from empirical_mvm_torch.data.tokenizer import load_tokenizer
    from empirical_mvm_torch.tools import loaderbench as lb
    lb.build_pretrain(str(tmp_path), videos_per_part=12, images=12)
    run = lb.with_data(load_run_config("configs/pretrain.json"), data_dir=str(tmp_path))
    run = dataclasses.replace(run, train=dataclasses.replace(run.train, size_batch=6))
    dec = NvJpegDecoder(cuda)

    def host_decode(data):
        from empirical_mvm_torch.data.jpeg import jpeg_size
        out = dec.decode([data], [jpeg_size(data)])[0]
        return None if out is None else out.cpu().numpy()

    runs = []
    for device, decode in ((cuda, None), ("cpu", host_decode)):
        meta = lb.pretrain_meta_loader(run, load_tokenizer(), threads=3)
        it = iter(DevicePrefetcher(meta, device, decode))
        runs.append([next(it) for _ in range(5)])
        it.close()
        meta.close()
    for (tag_a, a), (tag_b, b) in zip(*runs):
        assert tag_a == tag_b and a.keys() == b.keys()
        for k in a:
            if k == "img":
                assert a[k].is_cuda and (a[k].cpu().int() - b[k].int()).abs().max() <= 1
            else:
                assert torch.equal(a[k].cpu(), b[k]), k
    assert any(a["corrupt"].any() for _, a in runs[0])


# ---------------------------------------------------- checkpoints and the CLIs

TINY_RUN = {"size_img": 64, "size_frame": 2, "size_txt": 12, "size_batch": 4, "n_workers": 2,
            "swin_custom": {"embed_dim": 32, "depths": [1, 1, 1, 1], "num_heads": [1, 2, 4, 8],
                            "drop_path_rate": 0.0},
            "fusion": {"hidden_size": 128, "num_hidden_layers": 2, "num_attention_heads": 2,
                       "intermediate_size": 256},
            "text": {"hidden_size": 128, "num_hidden_layers": 2, "num_attention_heads": 2,
                     "intermediate_size": 256}}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_round_trip_on_the_card(cuda, tmp_path, dtype):
    """``save_params`` / ``load_params`` of a model on the card, its leaves
    fp32 or cast to bf16: every leaf back bit-equal, dtype kept (bf16
    through the codec's int16 view)."""
    from empirical_mvm_torch.core.config import load_run_config
    from empirical_mvm_torch.models.tasks import VioletRetrieval
    from empirical_mvm_torch.train.checkpoint import load_params, save_params
    run = load_run_config(TINY_RUN)
    model = VioletRetrieval(run.model, dtype=torch.bfloat16, device=cuda, seed=3)
    sd = {k: v.to(dtype) for k, v in model.state_dict().items()}
    path = str(tmp_path / "ckpt.msgpack")
    save_params(sd, path)
    back = load_params(path)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == dtype and torch.equal(back[k].to(cuda), v), k


@pytest.mark.cuda
def test_cli_main_runs_on_the_card(cuda, tmp_path):
    """``cli.retrieval.main`` with ``device="cuda"`` on a tiny config over
    the loaderbench layout (nvJPEG decodes): one epoch, its checkpoint, and
    the two-stage eval on it; ``device="cpu"`` without a decode function
    raises."""
    import json
    from empirical_mvm_torch.cli import retrieval, retrieval_eval
    from empirical_mvm_torch.tools.loaderbench import build_downstream
    data = tmp_path / "data"
    build_downstream(str(data), videos=12, test=6)
    cfg = tmp_path / "tiny-retrieval.json"
    cfg.write_text(json.dumps({"type": "retrieval", "task": "msrvtt-retrieval",
                               "dataset": ["msrvtt"], "data_dir": str(data),
                               "path_output": str(tmp_path / "out"), "size_epoch": 1,
                               "multi_clip_testing": True, **TINY_RUN}))
    res = retrieval.main(["--config", str(cfg)], device=cuda)
    assert res["steps"] == 3 and res["log"]["ls_tr"]
    ckpt = f"{res['run_dir']}/ckpt_violet_msrvtt-retrieval_1.msgpack"
    m = retrieval_eval.main(["--config", str(cfg), "--path_ckpt", ckpt], device=cuda)
    assert m["split"] == "test" and 1.0 <= m["medr"] and not m["load"]["kept"]
    with pytest.raises(ValueError, match="decode function"):
        retrieval.main(["--config", str(cfg)], device="cpu")


# ---------------------------------------------- data parallelism and remat


@pytest.mark.cuda
def test_nccl_process_group_of_one_rank(cuda, tmp_path, monkeypatch):
    """``distributed_init`` in the environment ``torch.distributed.run``
    sets for one process: NCCL on cuda:0; the gather in global order and the
    loss denominators are the identity at W = 1, the gradient reduce leaves
    the gradients as they are."""
    import socket
    import torch.distributed as dist
    from empirical_mvm_torch.parallel import mesh
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK="0",
                     WORLD_SIZE="1", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    dp = mesh.distributed_init("cuda")
    try:
        assert dp == mesh.DataParallel(0, 1) and dist.get_backend() == "nccl"
        assert mesh.rank_device("cuda") == torch.device("cuda", 0)
        x = torch.randn(4, 3, device=cuda, requires_grad=True)
        with mesh.data_parallel(dp):
            g = mesh.gather_rows(x)
            n = mesh.global_sum(torch.tensor(5, device=cuda))
        assert torch.equal(g, x) and n.item() == 5
        g.sum().backward()
        p = torch.nn.Parameter(torch.ones(3, device=cuda))
        p.grad = torch.full((3,), 2.0, device=cuda)
        mesh.reduce_gradients([p], dp)
        assert torch.equal(x.grad, torch.ones_like(x)) and torch.equal(p.grad, 2 * torch.ones(3,
                                                                                  device=cuda))
        assert mesh.all_gather_metrics([1.0, 2.0]) == [1.0, 2.0]
    finally:
        mesh.destroy()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_is_bit_equal_on_the_card(cuda, dtype):
    """A tiny pixel model (Video Swin at embed 32 on the kernels, BERT
    hidden 64) with dropout and drop path at 0.1, without and with remat:
    losses, every gradient and the dropout generator's state after the
    backward bit-equal."""
    from empirical_mvm_torch.core import config as tcfg
    from empirical_mvm_torch.models.pretrain import VioletPretrain
    from empirical_mvm_torch.train.train_step import step_generators
    rs = np.random.RandomState(0)
    img = torch.from_numpy(rs.randint(0, 256, (4, 2, 64, 64, 3)).astype(np.uint8)).to(cuda)
    txt = torch.from_numpy(rs.randint(1000, 2000, (4, 8))).to(cuda)
    txt[:, 0] = 101
    mask = torch.ones(4, 8, dtype=torch.int32, device=cuda)
    out = []
    for remat in (False, True):
        bert = tcfg.BertConfig(vocab_size=2000, hidden_size=64, num_hidden_layers=2,
                               num_attention_heads=2, intermediate_size=128, remat=remat)
        cfg = tcfg.ModelConfig(size_img=64, size_frame=2, size_txt=8, fusion=bert, text=bert,
                               swin_custom=tcfg.SwinConfig(embed_dim=32, depths=(1, 1, 1, 1),
                                                           num_heads=(1, 2, 4, 8),
                                                           drop_path_rate=0.1, remat=remat))
        model = VioletPretrain(cfg, dtype=dtype, device=cuda, seed=1)
        drop, masks = step_generators(3, 0, cuda)
        ls = model.losses(img, txt, mask, generator=drop, mask_generator=masks)
        ls["total"].backward()
        out.append(({k: v.item() for k, v in ls.items()},
                    {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None},
                    drop.get_state()))
    (l0, g0, s0), (l1, g1, s1) = out
    assert l0 == l1 and torch.equal(s0, s1) and set(g0) == set(g1)
    for name, g in g0.items():
        assert torch.equal(g, g1[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lane_kernels_at_the_merlot_vit_shape(cuda, dtype):
    """Rows 5 and 6 at the MERLOT encoder's trained ViT: 80 frames of 50
    tokens, 12 heads of 64, p = 0, the zero mask ``vit_self_attention``
    passes; against their plain versions."""
    rs = np.random.RandomState(21)
    p, l, d, nh = 80, 50, 768, 12
    x3 = _randn(rs, p, l, 3 * d, scale=0.5).to(cuda)
    do = _randn(rs, p, l, d).to(cuda).to(torch.bfloat16).float()
    mask = torch.zeros(1, 1, l, device=cuda).expand(p, l, l)
    seed = torch.zeros(2, dtype=torch.int32, device=cuda)
    (fk, fp, _), (bk, bp, _) = _lane_calls(mask, nh, (d // nh) ** -0.5, 0.0, seed, do)
    _check(fk, fp, x3, dtype, "attention" if dtype == torch.float32 else _lane_fwd_kind(64))
    _check(bk, bp, x3, dtype, "attention_bwd")


@pytest.mark.cuda
def test_r50_encoder_and_its_batch_norm_card_against_cpu(cuda):
    """``EncImgR50`` (concat, train-mode BatchNorm, biases at 3 as in
    chip_smoke's whole steps) in fp32 with TF32 off: the output within 1e-4
    of the CPU's, every gradient within 1e-3 of its tensor's largest value
    plus 1e-5 of the largest anywhere, the folded running statistics within
    2e-5 of their tensor's largest value."""
    from empirical_mvm_torch.core import config as tcfg
    from empirical_mvm_torch.models import common, encoders2d as tenc
    bert = tcfg.BertConfig(vocab_size=200, hidden_size=64, num_hidden_layers=1,
                           num_attention_heads=2, intermediate_size=128)
    cfg = tcfg.ModelConfig(size_img=64, size_frame=2, fusion=bert, text=bert)
    torch.manual_seed(0)
    cpu = tenc.EncImgR50(cfg, "concat", train_bn=True)
    with torch.no_grad():
        for m in cpu.modules():
            if isinstance(m, common.BatchNorm2d):
                m.bias.add_(3.0)
    card = tenc.EncImgR50(cfg, "concat", train_bn=True).to(cuda)
    card.load_state_dict(cpu.state_dict())
    img = torch.randn(2, 2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    outs = []
    for model, dev in ((card, cuda), (cpu, torch.device("cpu"))):
        out, _ = model(img.to(dev), torch.Generator(dev).manual_seed(0))
        (out * torch.linspace(-1, 1, out.numel(), device=dev).reshape(out.shape)).sum().backward()
        common.fold_bn_stats(model)
        outs.append((out.detach().cpu(), {n: p.grad.cpu() for n, p in model.named_parameters()
                                          if p.grad is not None},
                     {k: v.cpu() for k, v in common.bn_buffers(model).items()}))
    (o_c, g_c, b_c), (o_r, g_r, b_r) = outs
    torch.testing.assert_close(o_c, o_r, atol=1e-4, rtol=1e-4)
    top = max(g.abs().max().item() for g in g_r.values())
    for n, g in g_r.items():
        assert (g_c[n] - g).abs().max().item() <= 1e-3 * g.abs().max().item() + 1e-5 * top, n
    for k, v in b_r.items():
        assert (b_c[k] - v).abs().max().item() <= 2e-5 * v.abs().max().item(), k


@pytest.mark.cuda
def test_am_draw_on_the_card(cuda):
    """``draw_masks`` with ("am", "rm") on the card's generator: each am row
    masks exactly k slots, none special, and the draw repeats with the
    seed."""
    from empirical_mvm_torch.data import masking as tmask
    gen = torch.Generator(cuda).manual_seed(0)
    b, t, h, w, p = 16, 4, 7, 7, 0.15
    txt = torch.randint(104, 500, (b, 32), device=cuda, generator=gen)
    txt[:, 0], txt[:, 20], txt[:, 21:] = 101, 102, 0
    l = t * (1 + h * w) + 32
    scores = torch.rand(b, l, device=cuda, generator=gen) + 0.5
    kw = dict(special_token_ids=(101, 102, 0), mask_token_id=103, p_mask=p,
              mask_types=("am", "rm"), att_scores=scores)
    d = tmask.draw_masks(torch.Generator(cuda).manual_seed(3), txt, t, h, w, **kw)
    again = tmask.draw_masks(torch.Generator(cuda).manual_seed(3), txt, t, h, w, **kw)
    assert torch.equal(d.covs, again.covs) and torch.equal(d.txt_sel, again.txt_sel)
    k = max(int(l * p), 1)
    assert (d.covs[0].sum((1, 2, 3)) + d.txt_sel[0].sum(1) == k).all()
    assert not (d.txt_sel[0] & tmask.special_tokens(txt, (101, 102, 0), 103)).any()
