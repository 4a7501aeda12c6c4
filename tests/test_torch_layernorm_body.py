"""The LayerNorm kernels' vectorized body (csrc/layer_norm.cu,
``ln_vec_fwd_kernel`` / ``ln_vec_bwd_kernel``), its sum orders emulated in
torch on the CPU, against the plain versions.

A group of G lanes holds a row, lane l its 16-byte vectors v * G + l; a
lane sums its values in order (vector by vector), then a butterfly over the
group; the variance is that of the centred values, with an fma per term.
The backward gathers dgamma and dbeta per group over its rows in order, adds
a block's groups in a fixed order (half-warps, then warps 0-3) into one
partial row per block (2-4 blocks of 4 warps a SM, 132 SMs on the H100,
each over a contiguous range of rows), and sums the partials in 16 slices,
the slices' sums in order. Each emulation is held to chip_smoke's LayerNorm
limits (fp32 and bf16), and the planted faults of chip_smoke's
``PLANTED_LN`` are emulated and must fail them. No JAX here: the JAX
parity of the plain versions is tests/test_torch_ops.py and
tests/test_torch_train_ops.py.
"""

import math

import numpy as np
import pytest
import torch

from chip_smoke import (CAPTION_LN, CLIP_LN, DECODE_LN, EVAL_LN, FP32_LIMITS, LARGE_MEAN, LOADER_LN,
                        OUTPUTS, SMTM_LN, TEACHER3D_LN, TEACHER_LN, TRAIN_LN, _excess, _tuple,
                        bf16_check)
from empirical_mvm_torch.ops import layernorm as tln

H100_SMS = 132
BWD_THREADS = 128
SUM_WARPS = 16


def _shape(dtype, c):
    """(G, V, E) of the vectorized instantiation: lanes a row, vectors a
    lane, elements a vector."""
    e = 128 // torch.finfo(dtype).bits
    g = min(32, c // e)
    return g, c // (g * e), e


def _lanes(t, g, v, e):
    """(R, C) -> (R, G, V * E): each lane's values in its order."""
    return t.reshape(t.shape[0], v, g, e).permute(0, 2, 1, 3).reshape(t.shape[0], g, v * e)


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _lane_sums(terms, acc=None, fma_of=None):
    """Per-lane fp32 sums over the last axis, in order: s += t, or with
    ``fma_of`` = (a, b) s = fma(a, b, s)."""
    s = torch.zeros(terms.shape[:2]) if acc is None else acc
    for k in range(terms.shape[-1]):
        s = _fma(fma_of[0][..., k], fma_of[1][..., k], s) if fma_of else s + terms[..., k]
    return s


def _butterfly(p):
    """The xor butterfly over the group's lanes: lane i adds lane i ^ o for
    o = G / 2 .. 1 (the same value in every lane)."""
    while p.shape[-1] > 1:
        h = p.shape[-1] // 2
        p = p[..., :h] + p[..., h:]
    return p[..., 0]


def _stats(xf, g, v, e, eps, one_pass=False):
    """(mean, rstd, lanes of x) per row, as ``row_stats``; ``one_pass``:
    the planted fault, E[x^2] - mean^2."""
    c = xf.shape[-1]
    xl = _lanes(xf, g, v, e)
    mean = _butterfly(_lane_sums(xl)) / c
    d = xl if one_pass else xl - mean[:, None, None]
    var = _butterfly(_lane_sums(d, fma_of=(d, d))) / c
    if one_pass:
        var = var - mean * mean
    return mean, torch.rsqrt(var + eps)


def emulated_forward(x, gamma, beta, eps, one_pass=False):
    """``ln_vec_fwd_kernel`` on x (R, C) of its dtype."""
    g, v, e = _shape(x.dtype, x.shape[-1])
    xf = x.float()
    mean, rstd = _stats(xf, g, v, e, eps, one_pass)
    t = (xf - mean[:, None]) * rstd[:, None]
    return _fma(t, gamma, beta).to(x.dtype)


def _bwd_blocks_per_sm(v):
    """``ln_bwd_blocks_per_sm``: blocks a SM by the registers a lane's
    vectors of a row take (4 V)."""
    return 4 if 4 * v <= 4 else 3 if 4 * v <= 8 else 2


def _partials_order(rows, groups, per_sm, sms):
    """The vectorized backward's grid: (blocks, rows per block)."""
    most = min(per_sm * sms, -(-rows // groups))
    per = -(-rows // most)
    return -(-rows // per), per


def emulated_backward(x, gamma, dy, eps, sms=H100_SMS, drop_m2=False, skip_partial=False):
    """``ln_vec_bwd_kernel`` and ``layer_norm_bwd_sum_kernel`` on x, dy (R,
    C): dx in x's dtype, dgamma, dbeta. ``drop_m2`` and ``skip_partial``:
    the planted faults (the m2 term dropped from dx; the first partial left
    out of dgamma and dbeta)."""
    rows, c = x.shape
    g, v, e = _shape(x.dtype, c)
    xf, gy = x.float(), dy.float()
    mean, rstd = _stats(xf, g, v, e, eps)
    xhat = (xf - mean[:, None]) * rstd[:, None]
    dxhat = gy * gamma
    dl = _lanes(dxhat, g, v, e)
    m1 = _butterfly(_lane_sums(dl)) / c
    m2 = _butterfly(_lane_sums(dl, fma_of=(dl, _lanes(xhat, g, v, e)))) / c
    a = dxhat - m1[:, None]
    b = a if drop_m2 else (a.double() - xhat.double() * m2[:, None].double()).float()
    dx = (rstd[:, None] * b).to(x.dtype)

    groups = BWD_THREADS // g
    blocks, per = _partials_order(rows, groups, _bwd_blocks_per_sm(v), sms)
    steps = -(-per // groups)
    # row of (block, group, step): first + group + step * groups, or -1 past
    # the block's range
    blk = torch.arange(blocks)[:, None, None]
    row = blk * per + torch.arange(groups)[None, :, None] + groups * torch.arange(steps)
    valid = (row < torch.clamp(blk * per + per, max=rows))
    acc_g = torch.zeros(blocks, groups, c)
    acc_b = torch.zeros(blocks, groups, c)
    for k in range(steps):
        r = row[..., k].clamp(max=rows - 1)
        ok = valid[..., k][..., None]
        gk, xk = gy[r], xhat[r]
        acc_g = torch.where(ok, _fma(gk, xk, acc_g), acc_g)
        acc_b = torch.where(ok, acc_b + gk, acc_b)
    parts = []
    for acc in (acc_g, acc_b):
        if g < 32:                                        # half-warps: lower + upper
            acc = acc[:, 0::2] + acc[:, 1::2]
        t = acc[:, 0]
        for w in range(1, acc.shape[1]):                  # warps 0, 1, ... in turn
            t = t + acc[:, w]
        parts.append(t)
    part = torch.cat(parts, dim=1)                        # (blocks, 2C)
    slice_ = -(-blocks // SUM_WARPS)
    red = []
    for w in range(SUM_WARPS):
        s = torch.zeros(2 * c)
        for blk_i in range(w * slice_ + (1 if skip_partial and w == 0 else 0),
                           min(blocks, (w + 1) * slice_)):
            s = s + part[blk_i]
        red.append(s)
    total = red[0]
    for w in range(1, SUM_WARPS):
        total = total + red[w]
    return dx, total[:c], total[c:]


def _inputs(rows, c, seed, mean=0.5, std=2.0):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy((rs.randn(rows, c) * std + mean).astype(np.float32))
    gamma = torch.from_numpy((1.0 + 0.1 * rs.randn(c)).astype(np.float32))
    beta = torch.from_numpy((0.1 * rs.randn(c)).astype(np.float32))
    dy = torch.from_numpy(rs.randn(rows, c).astype(np.float32)).to(torch.bfloat16).float()
    return x, gamma, beta, dy


def _fp32_failures(kernel, plain, act, kind):
    failures = []
    for name, out, ref in zip(OUTPUTS[kind], _tuple(kernel(act)), _tuple(plain(act))):
        over = _excess((out - ref).abs(), ref, **FP32_LIMITS[kind][name])
        if over > 0:
            failures.append(f"{name} fp32 over by {over:.3g}")
    return failures


def _check(kernel, plain, act, kind):
    """fp32 failures and bf16 (readings, failures) of an emulation."""
    fp32 = _fp32_failures(kernel, plain, act, kind)
    readings, bf16 = bf16_check(kernel, plain, act, kind)
    print(kind, act.shape, readings, fp32 + bf16)
    return fp32, bf16, readings


# (rows, C): the train fusion width at the EncVideo site's rows, the 2D
# teacher's stage-0 width (16 lanes a row) and its last merge (8 vectors a
# lane; the forward's alone) and stage 3 (the backward's widest)
WIDTHS = [(4000, 768), (2000, 128), (500, 2048)]
BWD_WIDTHS = [(4000, 768), (2000, 128), (1000, 1024)]


@pytest.mark.parametrize("rows,c", WIDTHS)
def test_vectorized_forward_order_fits_the_limits(rows, c):
    """The forward's sums in the vectorized body's order, at the paths'
    widths, within chip_smoke's ``layer_norm`` limits in fp32 and bf16."""
    x, gamma, beta, _ = _inputs(rows, c, seed=c)
    fp32, bf16, _ = _check(lambda a: emulated_forward(a, gamma, beta, 1e-5),
                           lambda a: tln.layer_norm_reference(a, gamma, beta, 1e-5), x,
                           "layer_norm")
    assert not fp32 and not bf16, fp32 + bf16


@pytest.mark.parametrize("rows,c", WIDTHS)
def test_vectorized_forward_at_a_large_row_mean(rows, c):
    """At a row mean of 50 and std 1 (chip_smoke's ``LARGE_MEAN``) the
    two-pass variance stays within the bf16 limits, and the one-pass
    variance (E[x^2] - mean^2, the planted fault) does not."""
    x, gamma, beta, _ = _inputs(rows, c, seed=c + 2, mean=LARGE_MEAN[0], std=LARGE_MEAN[1])

    def plain(a):
        return tln.layer_norm_reference(a, gamma, beta, 1e-5)

    readings, failures = bf16_check(lambda a: emulated_forward(a, gamma, beta, 1e-5), plain, x,
                                    "layer_norm")
    assert not failures, (failures, readings)
    readings, failures = bf16_check(
        lambda a: emulated_forward(a, gamma, beta, 1e-5, one_pass=True), plain, x, "layer_norm")
    print("one-pass", readings, failures)
    assert failures


def test_fp32_sums_at_a_large_mean_are_the_limits_own_size():
    """Why the large-mean input is held in bf16: in fp32, sums of 768 values
    near 50 round by about 1e-5 in any order (the plain version's too), the
    fp32 limit itself; bf16 values near 50 are multiples of 1/4, which the
    fp32 sums add exactly. At a mean of 16 fp32 holds the two-pass variance
    and still fails the one-pass one."""
    big = _inputs(4000, 768, seed=12, mean=LARGE_MEAN[0], std=LARGE_MEAN[1])[0]
    x16 = _lanes(big.to(torch.bfloat16).float(), 32, 3, 8)
    assert torch.equal(_butterfly(_lane_sums(x16)), x16.double().sum((1, 2)).float())
    x, gamma, beta, _ = _inputs(4000, 768, seed=12, mean=16.0, std=1.0)

    def plain(a):
        return tln.layer_norm_reference(a, gamma, beta, 1e-12)

    assert not _fp32_failures(lambda a: emulated_forward(a, gamma, beta, 1e-12), plain, x,
                              "layer_norm")
    assert _fp32_failures(lambda a: emulated_forward(a, gamma, beta, 1e-12, one_pass=True),
                          plain, x, "layer_norm")


@pytest.mark.parametrize("rows,c", BWD_WIDTHS)
def test_vectorized_backward_order_fits_the_limits(rows, c):
    """dx, dgamma and dbeta in the vectorized backward's order (row sums,
    per-group registers, the blocks' fixed order, the sliced sum of the
    partials) within chip_smoke's ``layer_norm_bwd`` limits."""
    x, gamma, _, dy = _inputs(rows, c, seed=c + 1)
    fp32, bf16, _ = _check(
        lambda a: emulated_backward(a, gamma, dy.to(a.dtype), 1e-12),
        lambda a: tln.layer_norm_backward_reference(a, gamma, dy.to(a.dtype), 1e-12), x,
        "layer_norm_bwd")
    assert not fp32 and not bf16, fp32 + bf16


def test_backward_grid_at_the_fusion_site():
    """At the train fusion site (18,560 rows of 768 bf16: 3 vectors a lane)
    the backward runs 2 blocks of 4 warps a SM, at most 264 on the H100's 132
    SMs: 262 blocks of 71 rows, 262 partials, summed in 16 slices of 17."""
    blocks, per = _partials_order(18560, BWD_THREADS // 32, _bwd_blocks_per_sm(3), H100_SMS)
    assert (blocks, per) == (262, 71)
    assert blocks * per >= 18560 > (blocks - 1) * per
    assert math.ceil(blocks / SUM_WARPS) == 17


def test_planted_one_pass_variance_fails_at_the_fusion_site():
    """The one-pass variance, emulated at the train fusion site (18,560 rows
    of 768, bf16) at the large mean, fails the bf16 limits there."""
    x, gamma, beta, _ = _inputs(18560, 768, seed=9, mean=LARGE_MEAN[0], std=LARGE_MEAN[1])
    readings, failures = bf16_check(
        lambda a: emulated_forward(a, gamma, beta, 1e-12, one_pass=True),
        lambda a: tln.layer_norm_reference(a, gamma, beta, 1e-12), x, "layer_norm")
    print("one-pass", readings, failures)
    assert failures


def test_planted_m2_dropped_fails():
    x, gamma, _, dy = _inputs(2000, 768, seed=10)
    fp32, bf16, _ = _check(
        lambda a: emulated_backward(a, gamma, dy.to(a.dtype), 1e-12, drop_m2=True),
        lambda a: tln.layer_norm_backward_reference(a, gamma, dy.to(a.dtype), 1e-12), x,
        "layer_norm_bwd")
    assert any(f.startswith("dx") for f in fp32) and any(f.startswith("dx") for f in bf16)


def test_planted_missing_partial_fails():
    x, gamma, _, dy = _inputs(4000, 768, seed=11)
    fp32, bf16, _ = _check(
        lambda a: emulated_backward(a, gamma, dy.to(a.dtype), 1e-12, skip_partial=True),
        lambda a: tln.layer_norm_backward_reference(a, gamma, dy.to(a.dtype), 1e-12), x,
        "layer_norm_bwd")
    for failures in (fp32, bf16):
        assert any(f.startswith(("dgamma", "dbeta")) for f in failures), failures
        assert not any(f.startswith("dx") for f in failures), failures


SITES = [(label, rows, c, dtype) for label, rows, c, _, dtype in
         EVAL_LN + TRAIN_LN + TEACHER3D_LN + CLIP_LN + CAPTION_LN + SMTM_LN + DECODE_LN
         + LOADER_LN]


@pytest.mark.parametrize("label,rows,c,dtype", SITES, ids=[f"{s[0]}-{s[2]}" for s in SITES])
def test_every_path_site_takes_the_vectorized_body(label, rows, c, dtype):
    assert tln._ln_body(dtype, c) == "vectorized"
    assert c in tln.VECTOR_WIDTHS[dtype]
    g, v, e = _shape(dtype, c)
    assert g * v * e == c and g in (16, 32)


BWD_SITES = TRAIN_LN + CAPTION_LN + SMTM_LN + LOADER_LN


@pytest.mark.parametrize("label,rows,c,eps,dtype", BWD_SITES, ids=[s[0] for s in BWD_SITES])
def test_every_backward_site_takes_the_vectorized_body(label, rows, c, eps, dtype):
    assert tln._ln_body(dtype, c, backward=True) == "vectorized"


def test_other_widths_take_the_scalar_body():
    assert set(TEACHER_LN) <= set(TEACHER3D_LN)
    assert tln._ln_body(torch.float32, 96) == "scalar"
    assert tln._ln_body(torch.bfloat16, 96) == "scalar"
    assert tln._ln_body(torch.float32, 512) == "scalar"
    assert tln._ln_body(torch.bfloat16, 3072) == "scalar"
    assert tln._ln_body(torch.bfloat16, 2048) == "vectorized"
    assert tln._ln_body(torch.bfloat16, 2048, backward=True) == "scalar"
