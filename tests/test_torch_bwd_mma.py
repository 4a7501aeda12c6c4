"""The tensor-core backwards of the window attention (rows 8, 9, 10:
``csrc/attention_bwd_mma.cuh``; row 4, the direct backward: its one-pass
body ``csrc/attention_bwd_onepass.cuh``) and of the lane self-attention (row
6: row 11's ``csrc/self_attention_mma.cuh`` on x3's strides), checked on the
CPU.

A CUDA kernel cannot run here, so each body's fp32 arithmetic is emulated in
torch on bf16 inputs: the scores and dp summed over d in 16-wide k-steps, the
rows' max and sum and D = rowsum(dp * p) as per-thread partial sums combined
over a quad, p = exp(s - max) / sum, dq, dk and dv summed over 16-wide
k-steps of keys or queries. The emulation is held, with ``chip_smoke``'s
``bf16_check``, to the limits the chip run holds the kernels to, against the
plain backward run in fp32 and in bf16, at one head of the train step's
shapes: a Video Swin window of N = 196 with bias and shift mask, and the
fusion's L = 232 with its padding mask and dropout; the one-pass body from
the forward's row max and sum at N = 196, 245 and 49. The planted faults of
``chip_smoke.PLANTED_TILED`` for these bodies, and the one-pass body's
(statistics of another window or row, a dbias tile under the wrong owner),
emulated, fail them. Also: the body rules, and the
stride triples the tensor-core launchers use for the lane and packed
layouts against index arithmetic.
"""

import numpy as np
import pytest
import torch

from chip_smoke import BF16_LIMITS, P_ATTN, bf16_check
from empirical_mvm_torch.models.video_swin import _shift_attn_mask
from empirical_mvm_torch.ops import window_attention as twa

T = torch.from_numpy
INF = float("inf")


def _ksteps(a, b):
    """a @ b in fp32 as the tensor cores sum it: exact products, one 16-wide
    k-step at a time added to the accumulator."""
    out = None
    for k0 in range(0, a.shape[-1], 16):
        step = a[..., k0:k0 + 16] @ b[..., k0:k0 + 16, :]
        out = step if out is None else out + step
    return out


def _thread_order(t, n, fill):
    """(..., n_rows, n) fp32 terms, padded with ``fill`` to chunks of 16
    keys, as (..., n_rows, 4 threads, terms in each thread's order): thread
    tq of a quad holds keys c * 16 + nt * 8 + 2 * tq + u, chunk by chunk
    (c, nt, u)."""
    padded = -(-n // 16) * 16
    tp = torch.nn.functional.pad(t, (0, padded - n), value=fill)
    v = tp.view(*t.shape[:-1], padded // 16, 2, 4, 2)
    return v.movedim(-2, -4).reshape(*t.shape[:-1], 4, padded // 4)


def _quad_stats(s, n):
    """The rows' max and sum the kernels form from fp32 scores s (..., n):
    per thread a running max and sum, chunk by chunk of 16 keys, then the
    quad's four combined (max, then sum * exp(max - row max), xor 1 then 2)."""
    sv = _thread_order(s, n, -INF)
    chunks = sv.shape[-1] // 4
    mx = torch.full(sv.shape[:-1], -INF)
    total = torch.zeros(sv.shape[:-1])
    for c in range(chunks):
        vals = sv[..., 4 * c:4 * c + 4]
        m = torch.maximum(mx, vals.max(-1).values)
        total = torch.where(m != mx, total * torch.exp(mx - m), total)
        mx = m
        for u in range(4):
            total = total + torch.where(m == -INF, 0.0, torch.exp(vals[..., u] - m))
    row_max = mx.max(-1).values
    part = torch.where(mx == row_max[..., None], total, total * torch.exp(mx - row_max[..., None]))
    row_sum = (part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3])
    return row_max, row_sum


def _quad_rowsum(t, n):
    """rowsum of fp32 terms t (..., n) as the kernels sum D: each thread its
    keys in order, then (t0 + t1) + (t2 + t3)."""
    tv = _thread_order(t, n, 0.0)
    acc = torch.zeros(tv.shape[:-1])
    for x in range(tv.shape[-1]):
        acc = acc + tv[..., x]
    return (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])


def _probs(s, n):
    row_max, row_sum = _quad_stats(s, n)
    return torch.exp(s - row_max[..., None]) / row_sum[..., None]


def _r16(t):
    return t.to(torch.bfloat16).float()


def _grads(q, k, v, do, p, dp_rows, dp_cols, keep_cols, inv_keep, scale, d_rows):
    """dq, dk, dv of the tensor-core bodies from fp32 p and the dp that the
    rows and the columns pass each see (under the keep mask or not)."""
    dq_ds = _r16(p * (dp_rows - d_rows[..., None]))
    dk_ds = _r16(p * (dp_cols - d_rows[..., None]))
    p_drop = p if keep_cols is None else torch.where(keep_cols, p * inv_keep, 0.0)
    qs = (q * twa._scale_in(q.dtype, scale)).float()
    dq = _r16(_ksteps(dq_ds, k.float()) * twa._scale_f32(scale))
    dk = _r16(_ksteps(dk_ds.transpose(-1, -2), qs))
    dv = _r16(_ksteps(_r16(p_drop).transpose(-1, -2), do.float()))
    return dq, dk, dv


def _window_bwd_emulated(qkv16, bias, mask, do16, scale, ds_rounded_into_dbias=False):
    """The window body (attention_bwd_mma.cuh) on W windows (W, 3, N, 32)
    of one head and one mask slot: (dqkv, dbias), dbias the fp32 ds summed
    over the windows in order. ``ds_rounded_into_dbias``: chip_smoke's
    planted fault, ds rounded to bf16 before it enters dbias."""
    q, k, v = qkv16.unbind(1)
    n = q.shape[-2]
    qs = (q * twa._scale_in(q.dtype, scale)).float()
    s = _ksteps(qs, k.float().transpose(-1, -2)) + bias + mask
    p = _probs(s, n)
    dp = _ksteps(do16.float(), v.float().transpose(-1, -2))
    d = _quad_rowsum(dp * p, n)
    ds = p * (dp - d[..., None])
    dq, dk, dv = _grads(q, k, v, do16, p, dp, dp, None, 1.0, scale, d)
    into = _r16(ds) if ds_rounded_into_dbias else ds
    dbias = torch.zeros_like(ds[0])
    for w in range(ds.shape[0]):
        dbias = dbias + into[w]
    return torch.stack([dq, dk, dv], 1), dbias


def _lane_bwd_emulated(x3_16, mask, do16, nh, scale, seed, keep_in_rows=True):
    """Row 6 on row 11's tensor-core backward: the statistics pass (the
    forward's pass 1), the rows kernel (D, then ds and dq, dp under the keep
    mask) and the columns kernel (dk, dv). ``keep_in_rows`` False:
    chip_smoke's planted fault, the keep mask dropped from dp in the rows
    kernel."""
    b, l, c3 = x3_16.shape
    q, k, v = twa._lane_heads(x3_16, nh)
    dof = do16.reshape(b, l, nh, -1).transpose(1, 2)
    qs = (q * twa._scale_in(q.dtype, scale)).float()
    s = _ksteps(qs, k.float().transpose(-1, -2)) + mask[:, None]
    p = _probs(s, l)
    keep = twa.dropout_keep(seed, (b, nh, l, l), P_ATTN)
    inv = twa._inv_keep(P_ATTN)
    dp = _ksteps(dof.float(), v.float().transpose(-1, -2))
    dp_drop = torch.where(keep, dp * inv, 0.0)
    dp_rows = dp_drop if keep_in_rows else dp
    d = _quad_rowsum(dp_rows * p, l)
    dq, dk, dv = _grads(q, k, v, dof, p, dp_rows, dp_drop, keep, inv, scale, d)
    return torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(b, l, c3)


def _window_case(seed=0, windows=4):
    """W windows of one Video Swin-base head at the train step's window
    (4, 7, 7), N = 196, hd = 32, sharing the bias and the last shift-mask
    slot of stage 0: qkv (W, 3, N, 32), bias (1, N, N), mask (1, N, N),
    do (W, 1, N, 32) in bf16 values."""
    rs = np.random.RandomState(seed)
    n = 196
    qkv = T((rs.randn(windows, 3, n, 32) * 0.5).astype(np.float32))
    bias = T((rs.randn(1, n, n) * 0.02).astype(np.float32))
    mask = T(_shift_attn_mask((4, 56, 56), (4, 7, 7), (0, 3, 3))[-1:].copy())
    do = _r16(T(rs.randn(windows, 1, n, 32).astype(np.float32)))
    return qkv, bias, mask, do


def _window_check(fault=False):
    qkv, bias, mask, do = _window_case()
    scale = 32 ** -0.5

    def emulated(a):
        dqkv, dbias = _window_bwd_emulated(a, bias[0], mask[0], do.to(a.dtype)[:, 0], scale,
                                           fault)
        return dqkv, dbias[None]

    def plain(a):
        return twa.packed_window_attention_backward_plain(a, bias, mask, do.to(a.dtype), 1, 1,
                                                          scale)

    readings, failures = bf16_check(emulated, plain, qkv, "attention_bwd")
    print(readings, failures)
    return readings, failures


def _onepass_emulated(qkv16, bias, mask, do16, scale, fault=None):
    """The direct backward's one-pass body (attention_bwd_onepass.cuh) on W
    windows (W, 3, N, 32) of one head and one mask slot: (dqkv, dbias).
    The forward's row statistics, each row's max and its sum over each
    half-warp's lanes then the xor butterfly (attention_fwd_mma.cuh); p =
    exp(s - max) / sum, the forward's p; D: per 16 x 16 tile each thread's
    four dp * p, then the quad's (xor 1, 2), then the tiles of a row in
    key-block order; dq, dk, dv
    summed tile by tile in the main pass's order (warp j, owning key block j,
    takes query block (j + t) mod N/16 at step t); dbias the fp32 ds summed
    over the windows in order. ``fault``: ``"stale"``, each window reads the
    previous window's statistics; ``"wrong_row"``, each row the next row's;
    ``"wrong_owner"``, each ds tile (i, j) added into dbias tile (i, j + 1)."""
    from test_torch_fwd_mma import _lane_sums
    q, k, v = qkv16.unbind(1)
    w, n = q.shape[0], q.shape[-2]
    nb = -(-n // 16)
    np_ = 16 * nb
    qs = (q * twa._scale_in(q.dtype, scale)).float()
    s = _ksteps(qs, k.float().transpose(-1, -2)) + bias + mask
    mx = s.max(-1, keepdim=True).values
    total = _lane_sums(torch.exp(s - mx), n)[..., None]
    if fault == "stale":
        mx, total = mx.roll(1, 0), total.roll(1, 0)
    elif fault == "wrong_row":
        mx, total = mx.roll(-1, 1), total.roll(-1, 1)
    p = torch.exp(s - mx) / total
    dp = _ksteps(do16.float(), v.float().transpose(-1, -2))
    terms = torch.nn.functional.pad(dp * p, (0, np_ - n)).view(w, n, nb, 2, 4, 2)
    d = torch.zeros(w, n)
    for j in range(nb):
        t = terms[:, :, j]                                     # (W, N, nt, tq, u)
        per = ((t[:, :, 0, :, 0] + t[:, :, 0, :, 1]) + t[:, :, 1, :, 0]) + t[:, :, 1, :, 1]
        d = d + ((per[..., 0] + per[..., 1]) + (per[..., 2] + per[..., 3]))
    ds = p * (dp - d[..., None])

    def tiles(t):
        return torch.nn.functional.pad(t, (0, np_ - n, 0, np_ - n))

    def rows(t):
        return torch.nn.functional.pad(t, (0, 0, 0, np_ - n))

    ds16, p16 = tiles(_r16(ds)), tiles(_r16(p))
    kf, qf, dof = rows(k.float()), rows(qs), rows(do16.float())
    dq, dk, dv = (torch.zeros(w, np_, 32) for _ in range(3))
    into = torch.zeros(np_, np_)
    dsp = tiles(ds)
    for step in range(nb):
        for j in range(nb):
            i = (j + step) % nb
            ri, rj = slice(16 * i, 16 * i + 16), slice(16 * j, 16 * j + 16)
            dq[:, ri] = dq[:, ri] + ds16[:, ri, rj] @ kf[:, rj]
            dk[:, rj] = dk[:, rj] + ds16[:, ri, rj].transpose(-1, -2) @ qf[:, ri]
            dv[:, rj] = dv[:, rj] + p16[:, ri, rj].transpose(-1, -2) @ dof[:, ri]
            if fault == "wrong_owner":
                into[ri, rj] = dsp[:, ri, 16 * ((j - 1) % nb):16 * ((j - 1) % nb) + 16].sum(0)
    dq = _r16(dq[:, :n] * twa._scale_f32(scale))
    dbias = torch.zeros(n, n)
    for x in range(w):
        dbias = dbias + ds[x]
    if fault == "wrong_owner":
        dbias = into[:n, :n]
    return torch.stack([dq, _r16(dk[:, :n]), _r16(dv[:, :n])], 1), dbias


def _onepass_check(n, fault=None):
    """The one-pass body, emulated on 4 windows of one Swin head at window
    (n // 49, 7, 7) with bias and the last shift-mask slot of a 14 x 14 map,
    held against the plain backward in fp32 and bf16."""
    rs = np.random.RandomState(n)
    qkv = T((rs.randn(4, 3, n, 32) * 0.5).astype(np.float32))
    bias = T((rs.randn(1, n, n) * 0.02).astype(np.float32))
    wd = n // 49
    mask = T(_shift_attn_mask((wd, 14, 14), (wd, 7, 7), (0, 3, 3))[-1:].copy())
    do = _r16(T(rs.randn(4, 1, n, 32).astype(np.float32)))
    scale = 32 ** -0.5

    def emulated(a):
        dqkv, dbias = _onepass_emulated(a, bias[0], mask[0], do.to(a.dtype)[:, 0], scale, fault)
        return dqkv, dbias[None]

    def plain(a):
        return twa.packed_window_attention_backward_plain(a, bias, mask, do.to(a.dtype), 1, 1,
                                                          scale)

    readings, failures = bf16_check(emulated, plain, qkv, "window_bwd_tc")
    print(n, fault, readings, failures)
    return readings, failures


@pytest.mark.parametrize("n", [196, 245, 49])
def test_direct_onepass_arithmetic_fits_its_bf16_limits(n):
    """The direct backward's one-pass body, emulated from the forward's
    statistics at N = 196 (bias and shift mask; dbias on chip), 245 (the
    slice in device memory: the same sum order) and 49, against plain bf16
    and fp32: within the ``window_bwd_tc`` limits the card holds it to."""
    readings, failures = _onepass_check(n)
    assert not failures, failures
    assert readings["mismatch_bf16[dbias]"] > 0          # the order is not plain's


@pytest.mark.parametrize("fault", ["stale", "wrong_row", "wrong_owner"])
def test_direct_onepass_planted_faults_break_the_limits(fault):
    """Planted faults of the one-pass body, emulated at N = 196: the
    statistics of another window or of the next row move dx3 and dbias past
    their limits; a ds tile added under the wrong owner moves dbias."""
    readings, failures = _onepass_check(196, fault)
    assert any(f.startswith("dbias") for f in failures), failures
    if fault != "wrong_owner":
        assert any(f.startswith("dx3") for f in failures), failures


def _lane_case(seed=1, rows=2):
    """Rows of the fusion at the train step's shape: L = 232 (200 video + a
    caption of 6 to 32 tokens), 12 heads of 64; the (B, L, L) view of the
    padding bias; do in bf16 values."""
    rs = np.random.RandomState(seed)
    l, d = 232, 768
    x3 = T((rs.randn(rows, l, 3 * d) * 0.5).astype(np.float32))
    keep = np.ones((rows, l), np.float32)
    lens = rs.randint(6, 33, rows)
    keep[:, 200:] = (np.arange(32)[None] < lens[:, None])
    bias = T((1.0 - keep) * np.finfo(np.float32).min)
    do = _r16(T(rs.randn(rows, l, d).astype(np.float32)))
    return x3, bias[:, None, :].expand(rows, l, l), do


def _lane_check(keep_in_rows=True):
    x3, mask, do = _lane_case()
    nh, scale = 12, 64 ** -0.5
    seed = torch.tensor([20261016, 7], dtype=torch.int32)
    readings, failures = bf16_check(
        lambda a: _lane_bwd_emulated(a, mask, do.to(a.dtype), nh, scale, seed, keep_in_rows),
        lambda a: twa.lane_self_attention_backward_plain(a, mask, do.to(a.dtype), nh, scale,
                                                         P_ATTN, seed),
        x3, "attention_bwd")
    print(readings, failures)
    return readings, failures


def test_window_backward_arithmetic_fits_its_bf16_limits():
    """The window body's sum orders, emulated at N = 196 with bias and shift
    mask, against plain bf16 and fp32: within every attention_bwd limit,
    dx3's mismatch share under chip_smoke's limit, dbias within 1e-4 of its
    scale."""
    readings, failures = _window_check()
    assert not failures, failures
    assert readings["mismatch_bf16[dbias]"] > 0          # the order is not plain's


def test_window_planted_fault_breaks_the_dbias_limit():
    """chip_smoke's planted fault of the window body, emulated: ds rounded
    to bf16 before it enters dbias moves dbias past its 1e-4 scale limit."""
    _, failures = _window_check(fault=True)
    assert any(f.startswith("dbias") for f in failures), failures


def test_lane_backward_arithmetic_fits_its_bf16_limits():
    """Row 6 on the tensor-core body, emulated at L = 232 with the padding
    mask and dropout p = 0.1: within the attention_bwd limits."""
    readings, failures = _lane_check()
    assert not failures, failures
    assert readings["mismatch_bf16"] > 0


def test_lane_planted_fault_breaks_the_limits():
    """chip_smoke's planted fault of row 6, emulated: the keep mask dropped
    from dp in the rows kernel (D and ds for dq) fails the bf16 limits."""
    readings, failures = _lane_check(keep_in_rows=False)
    assert failures and readings["mismatch_bf16"] > 10 * BF16_LIMITS["attention_bwd"]["dx3"][2]


def test_window_and_lane_backward_body_rules():
    """The window backward runs the tensor cores for bf16 at hd 32 only; the
    lane backward takes row 11's rule (bf16 at hd 32, 64, 128); fp32 never."""
    for hd in (8, 16, 24, 32, 48, 64, 96, 128):
        assert twa._window_bwd_body(torch.bfloat16, hd) == (
            "tensor_core" if hd == 32 else "cuda_core"), hd
        assert twa._window_bwd_body(torch.float32, hd) == "cuda_core"
        assert twa._sa_body(torch.bfloat16, hd) == (
            "tensor_core" if hd in (32, 64, 128) else "cuda_core"), hd


def test_direct_backward_body_and_dbias_placement():
    """The direct backward takes the one-pass body for bf16 at hd 32 and N
    <= 256 and the CUDA-core body otherwise (fp32, another hd, more keys);
    the lane and packed backwards keep the window rule. The one-pass body's
    dbias placement is the kernel library's (on chip at N = 49 and 196, in
    device memory at 245), held on the card by
    ``test_torch_cuda.py::test_direct_onepass_backward``."""
    for hd in (16, 32, 64):
        for n in (49, 196, 245, 256, 257, 300):
            one_pass = hd == 32 and n <= 256
            assert twa._direct_bwd_body(torch.bfloat16, hd, n) == (
                "one_pass" if one_pass else "cuda_core")
            assert twa._direct_bwd_body(torch.float32, hd, n) == "cuda_core"
    assert twa._window_bwd_body(torch.bfloat16, 32) == "tensor_core"
    assert twa._window_bwd_body(torch.float32, 32) == "cuda_core"


@pytest.mark.parametrize("b,l,nh,hd", [(2, 232, 12, 64), (3, 24, 4, 32)])
def test_lane_stride_triples_address_x3(b, l, nh, hd):
    """The (row b, head h, token) strides of csrc/self_attention_mma.cuh
    ``launch_lane_bwd``: x3 and dx3 {3 L D, hd, 3 D} with k and v D and 2D
    further, dout {L D, hd, D}: element (b, h, t, e) of q, k, v and do in
    the lane layout (``_lane_heads``) is at that offset."""
    d = nh * hd
    x3 = torch.arange(b * l * 3 * d, dtype=torch.float64).reshape(b, l, 3 * d)
    do = torch.arange(b * l * d, dtype=torch.float64).reshape(b, l, d)
    xs, ds = (3 * l * d, hd, 3 * d), (l * d, hd, d)
    bi, hi, ti, ei = torch.meshgrid(*(torch.arange(x) for x in (b, nh, l, hd)), indexing="ij")
    flat = x3.flatten()
    for seg, heads in enumerate(twa._lane_heads(x3, nh)):
        off = seg * d + bi * xs[0] + hi * xs[1] + ti * xs[2] + ei
        assert torch.equal(flat[off], heads)
    dof = do.reshape(b, l, nh, hd).transpose(1, 2)
    assert torch.equal(do.flatten()[bi * ds[0] + hi * ds[1] + ti * ds[2] + ei], dof)
    assert all(s % 8 == 0 for s in (*xs, *ds, d))   # 16-byte cp.async rows


@pytest.mark.parametrize("b,nh,n,hd", [(2, 12, 350, 64), (4, 3, 196, 32)])
def test_packed_stride_triples_address_qkv(b, nh, n, hd):
    """Row 11's packed layout (B, 3nH, N, hd), ``tile_strides`` {3 nH N hd,
    N hd, hd} with k and v nH N hd and 2 nH N hd further, dout
    ``out_strides`` {nH N hd, N hd, hd}; and the packed window backward's
    ``addr`` (window stride 3 nH N hd, dout (b_ nH + h) N hd + t hd)."""
    qkv = torch.arange(b * 3 * nh * n * hd, dtype=torch.float64).reshape(b, 3 * nh, n, hd)
    bi, hi, ti, ei = torch.meshgrid(*(torch.arange(x) for x in (b, nh, n, hd)), indexing="ij")
    tile, out = (3 * nh * n * hd, n * hd, hd), (nh * n * hd, n * hd, hd)
    for seg, heads in enumerate(qkv.chunk(3, dim=1)):
        off = seg * nh * n * hd + bi * tile[0] + hi * tile[1] + ti * tile[2] + ei
        assert torch.equal(qkv.flatten()[off], heads)
        window = seg * nh * n * hd + bi * qkv[0].numel() + (hi * n + ti) * hd + ei
        assert torch.equal(qkv.flatten()[window], heads)
    do = torch.arange(b * nh * n * hd, dtype=torch.float64).reshape(b, nh, n, hd)
    assert torch.equal(do.flatten()[bi * out[0] + hi * out[1] + ti * out[2] + ei], do)
    assert torch.equal(do.flatten()[((bi * nh + hi) * n + ti) * hd + ei], do)
