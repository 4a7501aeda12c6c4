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

import shutil

import numpy as np
import pytest
import torch

from chip_smoke import FP32_LIMITS, OUTPUTS, _excess, _tuple, bf16_check
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
               x3, dtype, "attention")
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
           x3, dtype, "attention")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c,eps", [(40, 768, 1e-12), (250, 768, 1e-5), (7, 96, 1e-5)])
def test_fused_layer_norm_kernel(cuda, dtype, rows, c, eps):
    rs = np.random.RandomState(2)
    x = _randn(rs, rows, c, scale=2.0).to(cuda)
    g = _randn(rs, c, scale=0.1).to(cuda) + 1.0
    bt = _randn(rs, c, scale=0.1).to(cuda)
    _check(lambda a: tln.fused_layer_norm(a, g, bt, eps),
           lambda a: tln.layer_norm_reference(a, g, bt, eps), x, dtype, "layer_norm")


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
               x3, dtype, "attention")
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c,eps", [(40, 768, 1e-12), (4000, 768, 1e-5), (7, 96, 1e-5)])
def test_fused_layer_norm_bwd_kernel(cuda, dtype, rows, c, eps):
    rs = np.random.RandomState(6)
    x = _randn(rs, rows, c, scale=2.0).to(cuda)
    dy = _randn(rs, rows, c).to(cuda).to(torch.bfloat16).float()
    g = _randn(rs, c, scale=0.1).to(cuda) + 1.0
    _check(lambda a: tln._ln_bwd(a, g, dy.to(a.dtype), eps),
           lambda a: tln.layer_norm_backward_reference(a, g, dy.to(a.dtype), eps),
           x, dtype, "layer_norm_bwd")
    # two runs give bit-identical parameter gradients (no atomics)
    first, second = tln._ln_bwd(x, g, dy, eps), tln._ln_bwd(x, g, dy, eps)
    assert all(torch.equal(u, v) for u, v in zip(first, second))


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
}
# faults that also change the lane kernel at the fusion shape; at hd = 64 the
# scale is 0.125, so q * scale is exact in bf16 and q_scaled_in_fp32 is no
# fault there
LANE_FAULTS = {"probabilities_not_rounded"}


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [*PLANTED, "scale_not_rounded"])
def test_bf16_check_catches_planted_faults(cuda, tmp_path, monkeypatch, fault):
    """Each planted fault, built from a copy of the sources, fails the bf16
    limits at a main-path shape (swin stage 2, shifted: N = 245, hd = 32)
    and, for LANE_FAULTS, at the fusion shape. The readings are printed (run
    with -s)."""
    if fault in PLANTED:
        name, good, bad = PLANTED[fault]
        src = tmp_path / "csrc"
        shutil.copytree(_build.CSRC, src)
        text = (src / name).read_text()
        assert text.count(good) == 1
        (src / name).write_text(text.replace(good, bad))
        monkeypatch.setattr(_build, "CSRC", src)
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(_build, "_lib", None)

    def scale_for(a, scale):                # the wrapper's scale, or the fault's
        return scale if fault == "scale_not_rounded" else twa._scale_in(a.dtype, scale)

    gen = torch.Generator(cuda).manual_seed(0)
    win, nh, c, hp = (5, 7, 7), 16, 512, 14
    n = 5 * 7 * 7
    x3 = torch.randn(2, 5, hp, hp, 3 * c, device=cuda, generator=gen) * 0.5
    bias = torch.randn(nh, n, n, device=cuda, generator=gen) * 0.02
    mask = torch.from_numpy(_shift_attn_mask((5, hp, hp), win, (0, 3, 3))).to(cuda)
    scale = (c // nh) ** -0.5

    def direct(a):
        lib = _build.library()
        out = torch.empty(a.shape[:-1] + (c,), dtype=a.dtype, device=cuda)
        _build.record_launch(lib.emvm_direct_window_attention_fwd(
            _build.dtype_code(a.dtype), a.data_ptr(), bias.data_ptr(), mask.data_ptr(),
            out.data_ptr(), 2, 5, hp, hp, c, nh, 7, 7, scale_for(a, scale),
            _build.stream_ptr(cuda)), "direct_window_attention")
        return out

    cases = {"direct": bf16_check(
        direct, lambda a: twa.direct_window_attention_plain(a, bias, mask, win, nh, scale),
        x3, "attention")}
    if fault in LANE_FAULTS:
        p, l, d, lh = 16, 275, 768, 12
        xl = torch.randn(p, l, 3 * d, device=cuda, generator=gen) * 0.5
        keep = torch.ones(p, l, device=cuda)
        keep[:, 260:] = 0
        lmask = ((1.0 - keep) * torch.finfo(torch.float32).min)[:, None, :].expand(p, l, l)
        cases["lane"] = bf16_check(
            lambda a: twa.lane_self_attention(a, lmask, lh, (d // lh) ** -0.5),
            lambda a: twa.lane_self_attention_plain(a, lmask, lh, (d // lh) ** -0.5),
            xl, "attention")
    for case, (readings, failures) in cases.items():
        print(f"planted {fault} [{case}]: {readings} failures={failures}")
        assert failures, f"planted fault {fault} passes the bf16 limits at {case}"


# Faults planted in the backward kernels: the rounding of ds before its
# products, and the scale on dq (`_direct_bwd_kernel` :1499-1501,
# `_lane_sa_bwd_kernel` :1173-1175).
PLANTED_BWD = {
    "direct_ds_not_rounded": ("window_attention.cu", "rb[j] = to_float(from_float<T>(ds));",
                              "rb[j] = ds;"),
    "direct_dq_scale_dropped": ("window_attention.cu",
                                "dq[e] = from_float<T>(acc * scale_f);",
                                "dq[e] = from_float<T>(acc);"),
    "lane_ds_not_rounded": ("self_attention.cu",
                            "sm.rb[j] = to_float(from_float<T>(sm.ra[j] * (sm.rb[j] - dsum)));",
                            "sm.rb[j] = sm.ra[j] * (sm.rb[j] - dsum);"),
    "lane_dq_scale_dropped": ("self_attention.cu", "dq[e] = from_float<T>(acc * scale_f);",
                              "dq[e] = from_float<T>(acc);"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("fault", list(PLANTED_BWD))
def test_bf16_check_catches_planted_backward_faults(cuda, tmp_path, monkeypatch, fault):
    """Each planted backward fault, built from a copy of the sources, fails
    chip_smoke's bf16 backward limits at a train-path shape (swin stage 2,
    shifted: N = 196, hd = 32; or the fusion shape L = 232, hd = 64, with
    dropout). The readings are printed (run with -s)."""
    name, good, bad = PLANTED_BWD[fault]
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    text = (src / name).read_text()
    assert text.count(good) == 1
    (src / name).write_text(text.replace(good, bad))
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    gen = torch.Generator(cuda).manual_seed(0)
    if fault.startswith("direct"):
        win, nh, c, hp = (4, 7, 7), 16, 512, 14
        x3 = torch.randn(2, 4, hp, hp, 3 * c, device=cuda, generator=gen) * 0.5
        do = torch.randn(2, 4, hp, hp, c, device=cuda, generator=gen).to(torch.bfloat16)
        bias = torch.randn(nh, 196, 196, device=cuda, generator=gen) * 0.02
        mask = torch.from_numpy(_shift_attn_mask((4, hp, hp), win, (0, 3, 3))).to(cuda)
        scale = (c // nh) ** -0.5
        readings, failures = bf16_check(
            lambda a: twa._direct_bwd(a, bias, mask, do.to(a.dtype), win, nh, scale),
            lambda a: twa.direct_window_attention_backward_plain(a, bias, mask, do.to(a.dtype),
                                                                 win, nh, scale),
            x3, "attention_bwd")
    else:
        p, l, d, lh = 8, 232, 768, 12
        x3 = torch.randn(p, l, 3 * d, device=cuda, generator=gen) * 0.5
        do = torch.randn(p, l, d, device=cuda, generator=gen).to(torch.bfloat16)
        keep = torch.ones(p, l, device=cuda)
        keep[:, 220:] = 0
        lmask = ((1.0 - keep) * torch.finfo(torch.float32).min)[:, None, :].expand(p, l, l)
        seed = torch.tensor([77, 1], dtype=torch.int32, device=cuda)
        scale = (d // lh) ** -0.5
        readings, failures = bf16_check(
            lambda a: twa._lane_bwd(a, lmask, do.to(a.dtype), lh, scale, 0.1, seed),
            lambda a: twa.lane_self_attention_backward_plain(a, lmask, do.to(a.dtype), lh,
                                                             scale, 0.1, seed),
            x3, "attention_bwd")
    print(f"planted {fault}: {readings} failures={failures}")
    assert failures, f"planted fault {fault} passes the bf16 backward limits"
