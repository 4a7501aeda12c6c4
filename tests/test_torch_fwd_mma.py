"""The tensor-core forwards of the window attention (rows 3, 7, 9, 10 and
12: ``csrc/attention_fwd_mma.cuh``) and of the lane self-attention (row 5:
row 11's ``csrc/self_attention_mma.cuh`` forward on x3's strides), checked on
the CPU.

A CUDA kernel cannot run here, so each body's fp32 arithmetic is emulated in
torch on bf16 inputs and held, with ``chip_smoke``'s ``bf16_check``, to the
limits the chip run holds the kernels to, against the plain forward run in
fp32 and in bf16. The window body: the scores summed over d in 16-wide
k-steps, then bias, then mask; each row's max; e = exp(s - max), summed by
each lane of the row's half-warp over its keys (l, l + 16, ...) and then
over the 16 lanes by the xor butterfly (8, 4, 2, 1); p = e / sum rounded to
bf16; P.V in 16-key k-steps; at one head of N = 49, 196 and 245 with bias
and shift mask; in the lane layout of row 7 (N = 49, the 4-frame shift
mask or none) and of row 12, whose variant multiplies the fp32 scores by
the fp32 scale and leaves q as stored (N = 196, the lanebench tool's zero
mask and a shift-like mask over its slots). Row 5:
row 11's forward (the quads' running max and sum, ``_quad_stats``) at the
fusion's L = 232 with the padding mask and dropout, and L = 275 at p = 0.
The planted fault of ``chip_smoke.PLANTED_TILED`` for the window body,
emulated, fails, also at rows 7 and 12. Also: the direct layout's token
address against ``window_partition``, the lane layout's against the plain
version's heads, and the body rules of the forward routes with the limits
chip_smoke holds each body to.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (BF16_LIMITS, P_ATTN, _lane_fwd_kind, _shift_like_mask, _window_fwd_kind,
                        _window_shapes, bf16_check)
from empirical_mvm_torch.models.video_swin import _shift_attn_mask
from empirical_mvm_torch.ops import window_attention as twa
from empirical_mvm_torch.tools import lanebench
from test_torch_bwd_mma import _ksteps, _probs, _r16

T = torch.from_numpy
INF = float("inf")


def _half_sum(t):
    """(..., 16) per-lane sums added as attention_fwd_mma.cuh ``half_sum``
    adds them: shfl_xor 8, 4, 2, 1; every lane ends with the same value."""
    lanes = torch.arange(16)
    for o in (8, 4, 2, 1):
        t = t + t[..., lanes ^ o]
    return t[..., 0]


def _lane_sums(e, n):
    """The row sums of the window body: lane l of the row's half-warp adds
    e[..., l + 16 u] for u in order (0 past n), then the 16 lanes by
    ``_half_sum``."""
    iters = -(-n // 16)
    ep = torch.nn.functional.pad(e, (0, 16 * iters - n))
    per = ep.view(*e.shape[:-1], iters, 16)
    acc = torch.zeros(per.shape[:-2] + (16,))
    for u in range(iters):
        acc = acc + per[..., u, :]
    return _half_sum(acc)


def _window_fwd_emulated(qkv16, bias, mask, scale, fault=False, score_scale=False):
    """The window body (attention_fwd_mma.cuh) on W windows (W, 3, N, 32),
    bias and mask (N, N) or one a window (W, N, N): out (W, 1, N, 32) in
    bf16 values. ``fault``: chip_smoke's planted fault, e rounded to bf16
    before it is normalised (and p rounded again). ``score_scale``: the
    body's kScoreScale (row 12), q as stored and S * scale_f32 + bias."""
    q, k, v = qkv16.unbind(1)
    n = q.shape[-2]
    if score_scale:
        s = _ksteps(q.float(), k.float().transpose(-1, -2)) * torch.tensor(
            twa._scale_f32(scale)) + bias
    else:
        qs = (q * twa._scale_in(q.dtype, scale)).float()
        s = _ksteps(qs, k.float().transpose(-1, -2)) + bias
    if mask is not None:
        s = s + mask
    e = torch.exp(s - s.max(-1, keepdim=True).values)
    total = _lane_sums(e, n)[..., None]
    p = _r16(_r16(e) / total if fault else e / total)
    return _r16(_ksteps(p, v.float()))[:, None]


def _window_case(n, seed):
    """4 windows of one Swin head at window (n // 49, 7, 7), hd = 32, sharing
    the bias and the last shift-mask slot of a 14 x 14 map: qkv (4, 3, N,
    32), bias (1, N, N), mask (1, N, N)."""
    rs = np.random.RandomState(seed)
    wd = n // 49
    qkv = T((rs.randn(4, 3, n, 32) * 0.5).astype(np.float32))
    bias = T((rs.randn(1, n, n) * 0.02).astype(np.float32))
    mask = T(_shift_attn_mask((wd, 14, 14), (wd, 7, 7), (0, 3, 3))[-1:].copy())
    return qkv, bias, mask


def _window_check(n, masked=True, fault=False):
    qkv, bias, mask = _window_case(n, seed=n + masked)
    mask = mask if masked else None
    scale = 32 ** -0.5
    readings, failures = bf16_check(
        lambda a: _window_fwd_emulated(a, bias[0], None if mask is None else mask[0], scale,
                                       fault),
        lambda a: twa.packed_window_attention_plain(a, bias, mask, 1, 1, scale),
        qkv, "window_fwd_tc")
    print(n, masked, readings, failures)
    return readings, failures


@pytest.mark.parametrize("n", [49, 196, 245])
@pytest.mark.parametrize("masked", [True, False])
def test_window_forward_arithmetic_fits_its_bf16_limits(n, masked):
    """The window body's sum orders, emulated at N = 49, 196 and 245 (none a
    multiple of 16) with the bias, with and without the shift mask, against
    plain bf16 and fp32: within the ``window_fwd_tc`` limits."""
    readings, failures = _window_check(n, masked)
    assert not failures, failures
    assert readings["max_abs_err_bf16"] > 0


def test_window_planted_fault_breaks_the_limits():
    """chip_smoke's planted fault of the window body, emulated: e rounded to
    bf16 before it is normalised moves far more outputs than the mismatch
    limit allows."""
    readings, failures = _window_check(196, fault=True)
    assert failures
    assert readings["mismatch_bf16"] > 10 * BF16_LIMITS["window_fwd_tc"]["out"][2]


def _lane_fwd_emulated(x3_16, bias, mask, n_windows, nh, scale, fault=False,
                       score_scale=False):
    """The window body in the lane layout of rows 7 and 12 on x3 (B_, N,
    3C): each window-head of (B_ * nH) with bias[h] and mask[b_ % nW]."""
    b_, n, c3 = x3_16.shape
    qkv = x3_16.reshape(b_, n, 3, nh, -1).permute(0, 3, 2, 1, 4).reshape(b_ * nh, 3, n, -1)
    adds = bias.repeat(b_, 1, 1)
    mk = None if mask is None else mask[torch.arange(b_) % n_windows].repeat_interleave(nh, 0)
    o = _window_fwd_emulated(qkv, adds, mk, scale, fault, score_scale)
    return o.reshape(b_, nh, n, -1).transpose(1, 2).reshape(b_, n, c3 // 3)


def _row7_case(masked, seed):
    """Row 7 at the 2D swin's stage 2 in small: 2 clips of 4 frames of 4
    windows of 7 x 7 (B_ = 32, N = 49), 2 heads of 32, the 4-frame shift
    mask (nW = 16) or none."""
    rs = np.random.RandomState(seed)
    x3 = T((rs.randn(32, 49, 3 * 64) * 0.5).astype(np.float32))
    bias = T((rs.randn(2, 49, 49) * 0.02).astype(np.float32))
    mask = T(_shift_attn_mask((4, 14, 14), (1, 7, 7), (0, 3, 3))) if masked else None
    return x3, bias, mask, 16 if masked else 1


def _row12_case(mask_kind, seed):
    """Row 12 at the lanebench tool's stage-2 shape in small: 8 windows of
    N = 196, 2 heads of 32, nW = 4 slots of the tool's zero mask or of
    chip_smoke's shift-like mask."""
    rs = np.random.RandomState(seed)
    x3 = T((rs.randn(8, 196, 3 * 64) * 0.5).astype(np.float32))
    bias = T((rs.randn(2, 196, 196) * 0.1).astype(np.float32))
    mask = (torch.zeros(4, 196, 196) if mask_kind == "zero"
            else _shift_like_mask(torch.device("cpu"), torch.Generator().manual_seed(seed), 4,
                                  196))
    return x3, bias, mask


def _row7_check(masked, fault=False):
    x3, bias, mask, nw = _row7_case(masked, seed=49 + masked)
    scale = 32 ** -0.5
    readings, failures = bf16_check(
        lambda a: _lane_fwd_emulated(a, bias, mask, nw, 2, scale, fault),
        lambda a: twa.lane_window_attention_reference(a, bias, mask, nw, 2, scale),
        x3, _window_fwd_kind(32, 49))
    print("row 7", masked, readings, failures)
    return readings, failures


def _row12_check(mask_kind, fault=False):
    x3, bias, mask = _row12_case(mask_kind, seed=196 + len(mask_kind))
    scale = 32 ** -0.5
    readings, failures = bf16_check(
        lambda a: _lane_fwd_emulated(a, bias, mask, 4, 2, scale, fault, score_scale=True),
        lambda a: twa.lane_attention_reference(a, bias, mask, 2, scale),
        x3, _window_fwd_kind(32, 196))
    print("row 12", mask_kind, readings, failures)
    return readings, failures


@pytest.mark.parametrize("masked", [True, False])
def test_row7_forward_arithmetic_fits_its_bf16_limits(masked):
    """Row 7 on the window body, emulated in the lane layout at N = 49 with
    the bias, with the 4-frame shift mask and without, against
    ``lane_window_attention_reference`` in fp32 and bf16: within the
    ``window_fwd_tc`` limits."""
    readings, failures = _row7_check(masked)
    assert not failures, failures
    assert readings["max_abs_err_bf16"] > 0


@pytest.mark.parametrize("mask_kind", ["zero", "shift-like"])
def test_row12_forward_arithmetic_fits_its_bf16_limits(mask_kind):
    """Row 12 on the window body with the score scale (q as stored, the
    fp32 scores times the fp32 scale), emulated at N = 196 with the bias and
    the tool's zero mask or a shift-like mask over 4 slots, against
    ``lane_attention_reference`` in fp32 and bf16: within the
    ``window_fwd_tc`` limits."""
    readings, failures = _row12_check(mask_kind)
    assert not failures, failures
    assert readings["max_abs_err_bf16"] > 0


def test_row12_differs_from_row7_rounding():
    """The score-scale variant is another function in bf16: the same
    emulation with q * scale rounded (row 7's rounding) breaks row 12's
    limits against its plain version, so the test above tells them apart."""
    x3, bias, mask = _row12_case("zero", seed=200)
    readings, failures = bf16_check(
        lambda a: _lane_fwd_emulated(a, bias, mask, 4, 2, 32 ** -0.5),
        lambda a: twa.lane_attention_reference(a, bias, mask, 2, 32 ** -0.5),
        x3, _window_fwd_kind(32, 196))
    print(readings, failures)
    assert failures


@pytest.mark.parametrize("row", [7, 12])
def test_lane_planted_fault_breaks_the_limits(row):
    """chip_smoke's planted fault of the window body, emulated in the lane
    layouts of rows 7 (N = 49, shifted) and 12 (N = 196, shift-like mask),
    moves far more outputs than the mismatch limit allows."""
    readings, failures = _row7_check(True, fault=True) if row == 7 else _row12_check(
        "shift-like", fault=True)
    assert failures
    assert readings["mismatch_bf16"] > 10 * BF16_LIMITS["window_fwd_tc"]["out"][2]


@pytest.mark.parametrize("n_windows,masked", [(4, True), (4, False)])
def test_lane_token_address_matches_lane_window_heads(n_windows, masked):
    """csrc/lane_window_attention.cu ``addr``: head h of token t of window b_
    is element (b_ n + t) 3C + seg C + h hd of x3 for seg 0-2 (q, k, v) and
    (b_ n + t) C + h hd of out, with mask slot b_ % nW: the elements
    ``_lane_window_heads`` reads and the plain version writes."""
    b_, n, nh, hd = 12, 49, 3, 32
    c = nh * hd
    x3 = torch.arange(b_ * n * 3 * c).reshape(b_, n, 3 * c)
    mask = torch.zeros(n_windows, n, n) if masked else None
    nw = n_windows if masked else 1
    qkv, _ = twa._lane_window_heads(x3, torch.zeros(nh, n, n), mask, n_windows, nh)
    win = torch.arange(b_).reshape(b_ // nw, nw)[:, :, None, None, None]
    h = torch.arange(nh)[:, None, None]
    t = torch.arange(n)[:, None]
    d = torch.arange(hd)
    for seg in range(3):
        assert torch.equal(qkv[seg], (win * n + t) * 3 * c + seg * c + h * hd + d)
    assert torch.equal(win[:, :, 0, 0, 0] % nw, torch.arange(nw).expand(b_ // nw, nw))
    o = torch.arange(b_ * nh * n * hd).reshape(b_ // nw, nw, nh, n, hd)
    out = o.transpose(-2, -3).reshape(b_, n, c).flatten()
    assert torch.equal(out[(win * n + t) * c + h * hd + d], o)


@pytest.mark.parametrize("shape", [(2, 2, 14, 21, 5, (2, 7, 7)), (1, 5, 14, 14, 3, (5, 7, 7))])
def test_direct_token_address_matches_window_partition(shape):
    """csrc/window_attention.cu ``token_row``: token t of window w (row-major
    (h-strip, w)) of clip b is feature-map row ((b D + t / hw) Hp + strip wh
    + r / ww) Wp + col ww + r % ww, r = t % hw, the rows that
    ``window_partition`` gathers for window b nW + w."""
    b, d, hp, wp, c, win = shape
    _, wh, ww = win
    rows = torch.arange(b * d * hp * wp).reshape(b, d, hp, wp, 1)
    want = twa.window_partition(rows, win)[..., 0]           # (B * nW, N)
    nw, hw = (hp // wh) * (wp // ww), wh * ww
    got = torch.empty_like(want)
    for bi in range(b):
        for w in range(nw):
            strip, col = divmod(w, wp // ww)
            t = torch.arange(d * hw)
            tt, r = t // hw, t % hw
            got[bi * nw + w] = (((bi * d + tt) * hp + strip * wh + r // ww) * wp
                                + col * ww + r % ww)
    assert torch.equal(got, want)


def _row5_emulated(x3_16, mask, nh, scale, p_drop, seed):
    """Row 5 on row 11's tensor-core forward, in x3's layout: q * scale
    rounded, the scores in 16-wide k-steps plus the mask, the quads' running
    max and sum (``_probs``), p normalised, the keep mask from the same
    Philox counter, p rounded, P.V in 16-key k-steps, out rounded."""
    b, l, c3 = x3_16.shape
    q, k, v = twa._lane_heads(x3_16, nh)
    qs = (q * twa._scale_in(q.dtype, scale)).float()
    p = _probs(_ksteps(qs, k.float().transpose(-1, -2)) + mask[:, None], l)
    if p_drop:
        keep = twa.dropout_keep(seed, (b, nh, l, l), p_drop)
        p = torch.where(keep, p * twa._inv_keep(p_drop), 0.0)
    o = _r16(_ksteps(_r16(p), v.float()))
    return o.transpose(1, 2).reshape(b, l, c3 // 3)


@pytest.mark.parametrize("l,text,p_drop", [(232, 32, P_ATTN), (275, 25, 0.0)])
def test_row5_forward_arithmetic_fits_the_sa_limits(l, text, p_drop):
    """Row 5 at the train step's fusion shape (L = 232, p = 0.1) and the
    eval's (L = 275, p = 0), 12 heads of 64, the (B, L, L) view of the
    padding bias: within row 11's ``sa`` limits."""
    rs = np.random.RandomState(l)
    rows, d, nh = 2, 768, 12
    x3 = T((rs.randn(rows, l, 3 * d) * 0.5).astype(np.float32))
    keep = np.ones((rows, l), np.float32)
    keep[:, l - text:] = np.arange(text)[None] < rs.randint(3, text + 1, rows)[:, None]
    mask = T((1.0 - keep) * np.finfo(np.float32).min)[:, None, :].expand(rows, l, l)
    seed = torch.tensor([20261016, 7], dtype=torch.int32)
    scale = 64 ** -0.5
    readings, failures = bf16_check(
        lambda a: _row5_emulated(a, mask, nh, scale, p_drop, seed),
        lambda a: twa.lane_self_attention_plain(a, mask, nh, scale, p_drop, seed),
        x3, "sa")
    print(readings, failures)
    assert not failures, failures
    assert readings["mismatch_bf16"] > 0


def test_forward_body_rules():
    """The window forwards (direct, packed, lane window and lane_attention:
    rows 3, 7, 9, 10, 12) run the tensor cores for bf16 at hd 32 and N up to
    256, never in fp32; chip_smoke holds a window forward's bf16 to
    ``window_fwd_tc`` there and to the CUDA-core limits elsewhere, and row
    5's to row 11's ``sa`` where ``_sa_body`` picks the tensor cores. At
    every shape chip_smoke gives rows 7 (the 2D swin's, ``_window_shapes``)
    and 12 (the lanebench tool's stages) the bf16 body is the tensor cores'
    and the kind ``window_fwd_tc``."""
    for hd in (8, 16, 24, 32, 48, 64, 96, 128):
        for n in (49, 196, 245, 256, 257, 392):
            tc = hd == 32 and n <= 256
            assert twa._window_fwd_body(torch.bfloat16, hd, n) == (
                "tensor_core" if tc else "cuda_core"), (hd, n)
            assert twa._window_fwd_body(torch.float32, hd, n) == "cuda_core"
            assert _window_fwd_kind(hd, n) == ("window_fwd_tc" if tc else "attention")
        assert _lane_fwd_kind(hd) == ("sa" if hd in (32, 64, 128) else "attention"), hd
    row7 = [(c // nh, 49) for _, _, c, nh, _, _ in _window_shapes()]
    row12 = [(sh["c"] // sh["nh"], sh["n"]) for sh in lanebench.SHAPES.values()]
    assert len(row7) == 7 and len(row12) == 3
    for hd, n in row7 + row12:
        assert twa._window_fwd_body(torch.bfloat16, hd, n) == "tensor_core", (hd, n)
        assert twa._window_fwd_body(torch.float32, hd, n) == "cuda_core", (hd, n)
        assert _window_fwd_kind(hd, n) == "window_fwd_tc", (hd, n)
