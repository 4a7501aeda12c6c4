"""Window attention and BERT self-attention: CUDA kernels and plain versions.

Counterpart of ``empirical_mvm_tpu/ops/window_attention.py`` for the
kernels the retrieval eval and the pretrain step run:

* :func:`direct_window_attention` (``csrc/window_attention.cu``) replaces the
  Pallas ``_direct_fwd_kernel`` and ``_direct_bwd_kernel``: shifted-window
  attention read straight from the qkv GEMM output in the 5D feature-map
  layout (every student swin block), with its gradient to x3 and to the
  relative-position bias.
* :func:`lane_self_attention` (``csrc/self_attention.cu``) replaces the
  Pallas ``_lane_sa_fwd_kernel`` (with its in-kernel attention-probability
  dropout) and ``_lane_sa_bwd_kernel``: BERT attention read straight from
  the fused qkv output (every fusion layer).
* :func:`lane_window_attention` (``csrc/lane_window_attention.cu``) replaces
  the Pallas ``_lane_fwd_kernel`` and ``_lane_bwd_kernel``: window attention
  on partitioned windows (the per-frame windows of the 2D Swin, trained as
  the student or frozen as the 2d_feature teacher, which the TPU kernels
  take in their t-sliced form), with its gradient to x3 and to the
  relative-position bias.
* :func:`packed_window_attention` (``csrc/packed_window_attention.cu``)
  replaces the Pallas ``_attn_kernel`` and ``_attn_bwd_kernel`` as
  ``packed_window_attention`` runs them: window attention on q, k, v packed
  as (B_, 3nH, N, hd) head tiles (the swin stages whose width is no multiple
  of 128), with its gradient to qkv and to the bias.
  :func:`fused_window_attention`, the same kernels on q, k and v held as
  three arrays, replaces the JAX ``fused_window_attention``.
* :func:`packed_self_attention` (``csrc/self_attention_tiled.cu``) replaces
  the Pallas ``_sa_kernel`` and ``_sa_bwd_kernel`` as
  ``packed_self_attention`` runs them: BERT attention with a per-row mask
  and dropout on q, k, v packed as (B, 3nH, N, hd) head tiles, with K and V
  streamed in tiles, so any N fits; BERT takes it where
  :func:`lane_sa_attention_fits` refuses the lane kernel.
  :func:`fused_self_attention` is the same kernel on q, k and v held as
  three arrays (the JAX ``fused_self_attention``).
* :func:`lane_attention` (``csrc/lane_window_attention.cu``, the lane window
  kernel with the scale on the scores) replaces ``tools/lanebench.py``
  ``_lane_kernel``, the benchmark tool's forward-only window attention off
  the qkv GEMM output; ``empirical_mvm_torch/tools/lanebench.py`` runs it.

The window forwards (the direct row 3, the packed rows 9 and 10, the lane
window row 7 and ``lane_attention``, row 12, with the scale on the scores)
share one body: bf16 at hd 32 (N up to 256) runs on the tensor cores
(``csrc/attention_fwd_mma.cuh``), fp32 and other hd on the CUDA cores
(``attend_row``, :func:`_window_fwd_body`). Their backwards (all but row
12's, which has none) share another: bf16 at hd 32 on the tensor cores
(``csrc/attention_bwd_mma.cuh``), fp32 and other hd on the CUDA cores
(:func:`_window_bwd_body`). The lane self-attention in bf16 runs the tiled
self-attention's tensor-core kernels on x3's strides, forward and backward
(:func:`_sa_body`).

Each is a ``torch.autograd.Function``. A CPU tensor takes the plain versions
(forward and backward); a CUDA tensor launches the kernels or raises. The
plain versions repeat the kernels' rounding (q scaled in the input dtype,
fp32 scores and softmax, probabilities cast to v's dtype before P.V; in the
backward ds cast before its products and dq scaled by the fp32 scale), and
the dropout keep mask comes from the same Philox generator, written here in
integer tensor ops, so kernel and plain version drop the same elements.
:func:`window_attention_reference` is the JAX package's own XLA oracle.
"""

from __future__ import annotations

from typing import Sequence

import torch

from empirical_mvm_torch.ops import _build


def window_partition(x: torch.Tensor, window_size: Sequence[int]) -> torch.Tensor:
    """(B, D, H, W, C) -> (B*nW, wd*wh*ww, C), windows row-major over
    (d, h, w) blocks, tokens row-major as (t, i, j)."""
    b, d, h, w, c = x.shape
    wd, wh, ww = window_size
    x = x.reshape(b, d // wd, wd, h // wh, wh, w // ww, ww, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, wd * wh * ww, c)


def window_reverse(windows: torch.Tensor, window_size: Sequence[int], b: int,
                   d: int, h: int, w: int) -> torch.Tensor:
    """Inverse of :func:`window_partition`."""
    wd, wh, ww = window_size
    x = windows.reshape(b, d // wd, h // wh, w // ww, wd, wh, ww, -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def window_attention_reference(q, k, v, bias, mask, n_windows, scale):
    """The JAX package's XLA oracle: q, k, v (B_, nH, N, hd), bias (nH, N, N),
    mask (nW, N, N) with windows innermost in B_. fp32 scores, probabilities
    cast to v's dtype."""
    b_, nh, n, hd = q.shape
    s = torch.einsum("bhnd,bhmd->bhnm", q.float() * scale, k.float())
    s = s + bias[None]
    m = mask[None].expand(b_ // n_windows, n_windows, n, n)
    s = s + m.reshape(b_, 1, n, n)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhnm,bhmd->bhnd", p.float(), v.float()).to(q.dtype)


def _scale_in(dtype: torch.dtype, scale: float) -> float:
    """The softmax scale rounded to the storage dtype, as
    ``jnp.asarray(scale, dtype)`` rounds it in the JAX kernels."""
    return float(torch.tensor(scale, dtype=dtype))


def _scale_f32(scale: float) -> float:
    """The fp32 scale that multiplies dq (``dq * scale`` on an fp32 array)."""
    return float(torch.tensor(scale, dtype=torch.float32))


# ---------------------------------------------------------------------------
# Dropout: Philox4x32-10, the generator of csrc/common.cuh
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product a * b, a a 32-bit
    constant, b int64 holding 32-bit values; no intermediate exceeds 2^49."""
    t0 = b * (a & 0xFFFF)
    t1 = b * (a >> 16)
    mid = t0 + ((t1 & 0xFFFF) << 16)
    return ((t1 >> 16) + (mid >> 32)) & _MASK32, mid & _MASK32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding 32-bit counter words
    (broadcastable); returns the four 32-bit output words."""
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_threshold(p_drop: float) -> int:
    """Keep where the 32 random bits are >= this, so P(keep) = 1 - p (the
    JAX kernels' signed threshold ``int(p * 2^32) - 2^31``, unsigned)."""
    return min(_MASK32, int(p_drop * 2.0 ** 32))


def dropout_keep(seed: torch.Tensor, shape: Sequence[int], p_drop: float) -> torch.Tensor:
    """The keep mask of shape (B, nH, L, L) that the kernels draw from
    ``seed`` = (seed, offset) int32: element (b, h, i, j) takes word j % 4 of
    Philox at counter (j // 4, i, h, b)."""
    b, nh, l, lk = shape
    k0, k1 = (int(v) & _MASK32 for v in seed.tolist())
    dev = seed.device
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)   # noqa: E731
    groups = -(-lk // 4)
    words = philox4x32(ar(groups).view(1, 1, 1, -1), ar(l).view(1, 1, -1, 1),
                       ar(nh).view(1, -1, 1, 1), ar(b).view(-1, 1, 1, 1), k0, k1)
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1).reshape(b, nh, l, groups * 4)
    return bits[..., :lk] >= dropout_threshold(p_drop)


def draw_dropout_seed(generator: torch.Generator) -> torch.Tensor:
    """A per-call (seed, offset) pair of int32 on the generator's device."""
    return torch.randint(-2 ** 31, 2 ** 31, (2,), dtype=torch.int32,
                         generator=generator, device=generator.device)


# ---------------------------------------------------------------------------
# Plain attention, forward and backward, with the kernels' roundings
# ---------------------------------------------------------------------------

def _drop(t, keep, inv_keep):
    if keep is None:
        return t
    return torch.where(keep, t * torch.tensor(inv_keep, dtype=torch.float32), 0.0)


def _attend(q, k, v, adds, scale, keep=None, inv_keep=1.0):
    """dropout(softmax(q*scale . k^T + sum(adds))) . v with the kernels'
    rounding. q, k, v (..., N, hd); adds: fp32 terms broadcastable to
    (..., N, N); keep: bool keep mask of (..., N, N) or None."""
    qs = q * _scale_in(q.dtype, scale)
    s = qs.float() @ k.float().transpose(-1, -2)
    for a in adds:
        s = s + a
    p = _drop(torch.softmax(s, dim=-1), keep, inv_keep).to(v.dtype)
    return (p.float() @ v.float()).to(q.dtype)


def _attend_backward(q, k, v, adds, scale, do, keep=None, inv_keep=1.0):
    """Gradients of :func:`_attend` with the JAX backward kernels' algebra and
    roundings (``_direct_bwd_kernel``, ``_lane_sa_bwd_kernel``,
    ``_sa_bwd_kernel``): p recomputed in fp32, dv = round(p_drop)^T.do, dp
    under the keep mask, ds = p * (dp - rowsum(dp * p)), dq = (round(ds).k) *
    scale (fp32 scale), dk = round(ds)^T.qs. Returns dq, dk, dv in q's dtype
    and ds in fp32."""
    dt = q.dtype
    qs = (q * _scale_in(dt, scale)).float()
    kf, vf, dof = k.float(), v.float(), do.float()
    s = qs @ kf.transpose(-1, -2)
    for a in adds:
        s = s + a
    p = torch.softmax(s, dim=-1)
    dv = _drop(p, keep, inv_keep).to(dt).float().transpose(-1, -2) @ dof
    dp = _drop(dof @ vf.transpose(-1, -2), keep, inv_keep)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds_lo = ds.to(dt).float()
    dq = (ds_lo @ kf) * torch.tensor(_scale_f32(scale))
    dk = ds_lo.transpose(-1, -2) @ qs
    return dq.to(dt), dk.to(dt), dv.to(dt), ds


# ---------------------------------------------------------------------------
# direct_window_attention
# ---------------------------------------------------------------------------

def _check_direct(x3, bias, mask, window_eff, n_heads):
    b, d, hp, wp, c3 = x3.shape
    wd, wh, ww = window_eff
    c = c3 // 3
    n = wd * wh * ww
    if d != wd:
        raise ValueError(f"direct_window_attention needs one temporal window "
                         f"(D == wd), got D={d}, wd={wd}")
    if hp % wh or wp % ww:
        raise ValueError(f"direct_window_attention needs Hp, Wp padded to the "
                         f"window, got {(hp, wp)} for {(wh, ww)}")
    if c3 != 3 * c or c % n_heads:
        raise ValueError(f"last axis {c3} is not (3, {n_heads}, hd)")
    if bias.shape != (n_heads, n, n):
        raise ValueError(f"bias must be {(n_heads, n, n)}, got {tuple(bias.shape)}")
    nw = (hp // wh) * (wp // ww)
    if mask is not None and mask.shape != (nw, n, n):
        raise ValueError(f"mask must be {(nw, n, n)}, got {tuple(mask.shape)}")


def _direct_windows(x3, bias, mask, window_eff, n_heads):
    """q, k, v of every (window, head) as (B*nW, nH, N, hd) and the additive
    terms of the scores."""
    b, d, hp, wp, c3 = x3.shape
    xw = window_partition(x3, window_eff)                    # (B*nW, N, 3C)
    b_, n, _ = xw.shape
    qkv = xw.reshape(b_, n, 3, n_heads, c3 // 3 // n_heads).permute(2, 0, 3, 1, 4)
    adds = [bias[None]]
    if mask is not None:
        nw = mask.shape[0]
        adds.append(mask[None, :, None].expand(b, nw, n_heads, n, n)
                    .reshape(b_, n_heads, n, n))
    return qkv, adds


def direct_window_attention_plain(x3, bias, mask, window_eff, n_heads, scale):
    """Plain version of :func:`direct_window_attention`: partition, attend,
    reverse."""
    _check_direct(x3, bias, mask, window_eff, n_heads)
    b, d, hp, wp, c3 = x3.shape
    (q, k, v), adds = _direct_windows(x3, bias, mask, window_eff, n_heads)
    o = _attend(q, k, v, adds, scale)                         # (B_, nH, N, hd)
    o = o.transpose(1, 2).reshape(o.shape[0], -1, c3 // 3)
    return window_reverse(o, window_eff, b, d, hp, wp)


def direct_window_attention_backward_plain(x3, bias, mask, do, window_eff, n_heads,
                                           scale):
    """Plain backward of :func:`direct_window_attention`: dx3 in x3's layout
    and dtype, dbias (nH, N, N) fp32 summed over batch and windows."""
    _check_direct(x3, bias, mask, window_eff, n_heads)
    b, d, hp, wp, c3 = x3.shape
    (q, k, v), adds = _direct_windows(x3, bias, mask, window_eff, n_heads)
    b_, nh, n, hd = q.shape
    dow = window_partition(do, window_eff).reshape(b_, n, nh, hd).transpose(1, 2)
    dq, dk, dv, ds = _attend_backward(q, k, v, adds, scale, dow)
    dbias = ds.sum(0)
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(b_, n, c3)
    return window_reverse(dqkv, window_eff, b, d, hp, wp), dbias


def _window_fwd_body(dtype: torch.dtype, hd: int, n: int) -> str:
    """The body of the window forwards (the direct row 3, the packed rows 9
    and 10, the lane window row 7 and ``lane_attention``, row 12) that a
    launch runs, by the rule of their C entry points: bf16 at hd 32 (every
    Swin's head) and N <= 256 (49, 196 and 245 on the paths) on the tensor
    cores (``csrc/attention_fwd_mma.cuh``), fp32 and any other bf16 on the
    CUDA cores (``attend_row``)."""
    tc = dtype == torch.bfloat16 and hd == 32 and 1 <= n <= 256
    return "tensor_core" if tc else "cuda_core"


def _direct_fwd(x3, bias, mask, window_eff, n_heads, scale):
    tensors = (x3, bias) if mask is None else (x3, bias, mask)
    if any(t.dtype != torch.float32 for t in tensors[1:]):
        raise TypeError("bias and mask must be float32")
    dev = _build.check_tensors(*tensors)
    code = _build.dtype_code(x3.dtype)
    b, d, hp, wp, c3 = x3.shape
    wd, wh, ww = window_eff
    c = c3 // 3
    lib = _build.library()
    _build.check_smem(lib.emvm_window_attention_fwd_smem_bytes(code, wd * wh * ww,
                                                               c // n_heads),
                      f"a window of {wd * wh * ww} tokens")
    out = torch.empty((b, d, hp, wp, c), dtype=x3.dtype, device=dev)
    with torch.cuda.device(dev):
        _build.record_launch(lib.emvm_direct_window_attention_fwd(
            code, x3.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            b, d, hp, wp, c, n_heads, wh, ww, _scale_in(x3.dtype, scale),
            _build.stream_ptr(dev)), "direct_window_attention")
    return out


def _direct_bwd(x3, bias, mask, do, window_eff, n_heads, scale):
    tensors = (x3, bias, do) if mask is None else (x3, bias, do, mask)
    dev = _build.check_tensors(*tensors)
    if do.dtype != x3.dtype:
        raise TypeError(f"do is {do.dtype}, x3 {x3.dtype}")
    code = _build.dtype_code(x3.dtype)
    b, d, hp, wp, c3 = x3.shape
    wd, wh, ww = window_eff
    c = c3 // 3
    n = wd * wh * ww
    lib = _build.library()
    _build.check_smem(lib.emvm_direct_window_attention_bwd_smem_bytes(code, n, c // n_heads),
                      f"the backward of a window of {n} tokens")
    dx3 = torch.empty_like(x3)
    dbias = torch.empty((n_heads, n, n), dtype=torch.float32, device=dev)
    part = torch.empty(lib.emvm_direct_window_attention_bwd_scratch(b, d, hp, wp, n_heads,
                                                                    wh, ww),
                       dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _build.record_launch(lib.emvm_direct_window_attention_bwd(
            code, x3.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), do.data_ptr(), dx3.data_ptr(),
            dbias.data_ptr(), part.data_ptr(), b, d, hp, wp, c, n_heads, wh, ww,
            _scale_in(x3.dtype, scale), _scale_f32(scale), _build.stream_ptr(dev)),
            "direct_window_attention_bwd")
    return dx3, dbias


class _DirectWindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x3, bias, mask, window_eff, n_heads, scale):
        _check_direct(x3, bias, mask, window_eff, n_heads)
        ctx.save_for_backward(x3, bias, mask)
        ctx.config = (tuple(window_eff), n_heads, scale)
        if x3.device.type == "cpu":
            return direct_window_attention_plain(x3, bias, mask, window_eff, n_heads, scale)
        return _direct_fwd(x3, bias, mask, window_eff, n_heads, scale)

    @staticmethod
    def backward(ctx, do):
        x3, bias, mask = ctx.saved_tensors
        if x3.device.type == "cpu":
            dx3, dbias = direct_window_attention_backward_plain(x3, bias, mask, do,
                                                                *ctx.config)
        else:
            dx3, dbias = _direct_bwd(x3, bias, mask, do.contiguous(), *ctx.config)
        return dx3, dbias, None, None, None, None


def direct_window_attention(x3: torch.Tensor, bias: torch.Tensor,
                            mask: torch.Tensor | None,
                            window_eff: Sequence[int], n_heads: int,
                            scale: float) -> torch.Tensor:
    """Window attention on the native 5D layout (JAX
    ``direct_window_attention``), differentiable in x3 and bias.

    Args:
      x3:   (B, D, Hp, Wp, 3C) qkv output on the padded, rolled feature map,
            last axis ordered (3, nH, hd); D must equal window_eff[0].
      bias: (nH, N, N) fp32 relative-position bias, N = wd*wh*ww.
      mask: (nW, N, N) fp32 shift mask, windows row-major (h-strip, w), or
            None for an unshifted block. It gets no gradient.
    Returns:
      (B, D, Hp, Wp, C) in x3's dtype.
    """
    return _DirectWindowAttention.apply(x3, bias, mask, tuple(window_eff), n_heads, scale)


# ---------------------------------------------------------------------------
# lane_self_attention
# ---------------------------------------------------------------------------

def _check_lane(x3, mask, n_heads, p_drop, seed):
    b, l, c3 = x3.shape
    if c3 % 3 or (c3 // 3) % n_heads:
        raise ValueError(f"last axis {c3} is not (3, {n_heads}, hd)")
    if mask.shape != (b, l, l):
        raise ValueError(f"mask must be {(b, l, l)}, got {tuple(mask.shape)}")
    _check_drop(p_drop, seed)


def _check_drop(p_drop, seed):
    if not 0.0 <= p_drop < 1.0:
        raise ValueError(f"p_drop must be in [0, 1), got {p_drop}")
    if p_drop > 0.0 and (seed is None or seed.shape != (2,) or seed.dtype != torch.int32):
        raise ValueError("dropout needs a (2,) int32 (seed, offset) tensor")


def _lane_heads(x3, n_heads):
    b, l, c3 = x3.shape
    return x3.reshape(b, l, 3, n_heads, c3 // 3 // n_heads).permute(2, 0, 3, 1, 4)


def _lane_keep(x3, n_heads, p_drop, seed):
    if p_drop == 0.0:
        return None
    b, l, _ = x3.shape
    return dropout_keep(seed, (b, n_heads, l, l), p_drop)


def _inv_keep(p_drop: float) -> float:
    return float(torch.tensor(1.0 / (1.0 - p_drop), dtype=torch.float32))


def lane_self_attention_plain(x3, mask, n_heads, scale, p_drop=0.0, seed=None):
    """Plain version of :func:`lane_self_attention`'s forward; ``seed`` is
    the (seed, offset) int32 pair the kernel would be given."""
    _check_lane(x3, mask, n_heads, p_drop, seed)
    b, l, c3 = x3.shape
    q, k, v = _lane_heads(x3, n_heads)
    o = _attend(q, k, v, [mask[:, None]], scale, _lane_keep(x3, n_heads, p_drop, seed),
                _inv_keep(p_drop))
    return o.transpose(1, 2).reshape(b, l, c3 // 3)


def lane_self_attention_backward_plain(x3, mask, do, n_heads, scale, p_drop=0.0,
                                       seed=None):
    """Plain backward of :func:`lane_self_attention`: dx3 = [dq, dk, dv] in
    the (3, nH, hd) layout, regenerating the forward's keep mask."""
    _check_lane(x3, mask, n_heads, p_drop, seed)
    b, l, c3 = x3.shape
    q, k, v = _lane_heads(x3, n_heads)
    dof = do.reshape(b, l, n_heads, -1).transpose(1, 2)
    dq, dk, dv, _ = _attend_backward(q, k, v, [mask[:, None]], scale, dof,
                                     _lane_keep(x3, n_heads, p_drop, seed),
                                     _inv_keep(p_drop))
    return torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(b, l, c3)


def _lane_args(x3, mask, seed, p_drop):
    if mask.dtype != torch.float32 or mask.stride(2) != 1:
        raise TypeError("mask must be float32 with a contiguous key axis")
    for t in (mask, seed):
        if t is not None and t.device != x3.device:
            raise ValueError(f"tensors on {t.device} and {x3.device}")
    drop = (None, 0, 1.0) if p_drop == 0.0 else (
        seed.data_ptr(), dropout_threshold(p_drop), _inv_keep(p_drop))
    return (mask.data_ptr(), mask.stride(0), mask.stride(1)), drop


def _lane_fwd(x3, mask, n_heads, scale, p_drop, seed):
    """Launch the lane forward: bf16 at hd 32, 64 or 128 on row 11's
    tensor-core forward (``_sa_body``), the rest on the CUDA-core kernel."""
    (mptr, msb, msr), drop = _lane_args(x3, mask, seed, p_drop)
    dev = _build.check_tensors(x3)
    code = _build.dtype_code(x3.dtype)
    b, l, c3 = x3.shape
    c = c3 // 3
    lib = _build.library()
    _build.check_smem(lib.emvm_lane_self_attention_fwd_smem_bytes(code, l, c // n_heads),
                      f"a sequence of {l} tokens")
    out = torch.empty((b, l, c), dtype=x3.dtype, device=dev)
    with torch.cuda.device(dev):
        _build.record_launch(lib.emvm_lane_self_attention_fwd(
            code, x3.data_ptr(), mptr, msb, msr, out.data_ptr(), b, l, c, n_heads,
            _scale_in(x3.dtype, scale), *drop, _build.stream_ptr(dev)),
            "lane_self_attention" if p_drop == 0.0 else "lane_self_attention_dropout")
    return out


def _lane_bwd(x3, mask, do, n_heads, scale, p_drop, seed):
    """Launch the lane backward: bf16 at hd 32, 64 or 128 on row 11's
    tensor-core body (``_sa_body``), the rest on the CUDA-core kernels."""
    (mptr, msb, msr), drop = _lane_args(x3, mask, seed, p_drop)
    dev = _build.check_tensors(x3, do)
    if do.dtype != x3.dtype:
        raise TypeError(f"do is {do.dtype}, x3 {x3.dtype}")
    code = _build.dtype_code(x3.dtype)
    b, l, c3 = x3.shape
    c = c3 // 3
    lib = _build.library()
    _build.check_smem(lib.emvm_lane_self_attention_bwd_smem_bytes(code, l, c // n_heads),
                      f"the backward of a sequence of {l} tokens")
    dx3 = torch.empty_like(x3)
    # the rows' statistics and D: (B, nH, 3, L) for the CUDA-core body; for the
    # tensor-core body (``_sa_body``, row 11's) the max and sum (B, nH, 2, L)
    # of its statistics pass, then D (B, nH, L)
    stats = torch.empty(3 * b * n_heads * l, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _build.record_launch(lib.emvm_lane_self_attention_bwd(
            code, x3.data_ptr(), mptr, msb, msr, do.data_ptr(), dx3.data_ptr(),
            stats.data_ptr(), b, l, c, n_heads, _scale_in(x3.dtype, scale),
            _scale_f32(scale), *drop, _build.stream_ptr(dev)), "lane_self_attention_bwd")
    return dx3


class _LaneSelfAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x3, mask, seed, n_heads, scale, p_drop):
        _check_lane(x3, mask, n_heads, p_drop, seed)
        ctx.save_for_backward(x3, mask, seed)
        ctx.config = (n_heads, scale, p_drop)
        if x3.device.type == "cpu":
            return lane_self_attention_plain(x3, mask, n_heads, scale, p_drop, seed)
        return _lane_fwd(x3, mask, n_heads, scale, p_drop, seed)

    @staticmethod
    def backward(ctx, do):
        x3, mask, seed = ctx.saved_tensors
        n_heads, scale, p_drop = ctx.config
        if x3.device.type == "cpu":
            dx3 = lane_self_attention_backward_plain(x3, mask, do, n_heads, scale, p_drop,
                                                     seed)
        else:
            dx3 = _lane_bwd(x3, mask, do.contiguous(), n_heads, scale, p_drop, seed)
        return dx3, None, None, None, None, None


def lane_self_attention(x3: torch.Tensor, mask: torch.Tensor, n_heads: int,
                        scale: float, p_drop: float = 0.0,
                        generator: torch.Generator | None = None) -> torch.Tensor:
    """BERT self-attention off the fused qkv output (JAX
    ``lane_self_attention``), differentiable in x3.

    Args:
      x3:   (B, L, 3D), last axis ordered (3, nH, hd).
      mask: (B, L, L) fp32 additive bias. It may be a broadcast view (for
            example a (B, 1, 1, L) padding bias expanded over the query
            rows); only its key axis must be contiguous.
      p_drop: attention-probability dropout rate; above 0 it needs
            ``generator``, from which the call draws its (seed, offset).
    Returns:
      (B, L, D) in x3's dtype.
    """
    return _LaneSelfAttention.apply(x3, mask, _call_seed(p_drop, generator), n_heads, scale,
                                    float(p_drop))


def _call_seed(p_drop: float, generator: torch.Generator | None) -> torch.Tensor | None:
    """The (seed, offset) of one attention call with dropout, or None."""
    if p_drop <= 0.0:
        return None
    if generator is None:
        raise ValueError("attention dropout needs a generator")
    return draw_dropout_seed(generator)


# ---------------------------------------------------------------------------
# lane_window_attention
# ---------------------------------------------------------------------------

def _check_lane_window(x3, bias, mask, n_windows, n_heads):
    if x3.dim() != 3:
        raise ValueError(f"x3 must be (B_, n, 3C), got {tuple(x3.shape)}")
    b_, n, c3 = x3.shape
    if c3 % 3 or (c3 // 3) % n_heads:
        raise ValueError(f"last axis {c3} is not (3, {n_heads}, hd)")
    if bias.shape != (n_heads, n, n):
        raise ValueError(f"bias must be {(n_heads, n, n)}, got {tuple(bias.shape)}")
    if n_windows < 1 or b_ % n_windows:
        raise ValueError(f"{b_} windows are not a multiple of n_windows={n_windows}")
    if mask is not None and mask.shape != (n_windows, n, n):
        raise ValueError(f"mask must be {(n_windows, n, n)}, got {tuple(mask.shape)}")


def _lane_window_heads(x3, bias, mask, n_windows, n_heads):
    """q, k, v as (B_/nW, nW, nH, n, hd), window b_ = (period, b_ % nW), and
    the additive terms of the scores."""
    b_, n, c3 = x3.shape
    nw = n_windows if mask is not None else 1
    qkv = x3.reshape(b_ // nw, nw, n, 3, n_heads, c3 // 3 // n_heads).permute(3, 0, 1, 4, 2, 5)
    return qkv, ([bias] if mask is None else [bias, mask[:, None]])


def lane_window_attention_reference(x3, bias, mask, n_windows, n_heads, scale):
    """Plain version of :func:`lane_window_attention`, with the kernel's
    roundings: q * scale in the input dtype, fp32 scores, bias, mask and
    softmax, probabilities cast to v's dtype before P.V."""
    _check_lane_window(x3, bias, mask, n_windows, n_heads)
    b_, n, c3 = x3.shape
    (q, k, v), adds = _lane_window_heads(x3, bias, mask, n_windows, n_heads)
    o = _attend(q, k, v, adds, scale)
    return o.transpose(-2, -3).reshape(b_, n, c3 // 3)


def lane_window_attention_backward_plain(x3, bias, mask, do, n_windows, n_heads, scale):
    """Plain backward of :func:`lane_window_attention` with the algebra and
    roundings of the JAX ``_lane_bwd_kernel`` (:func:`_attend_backward`):
    dx3 (B_, n, 3C) in x3's dtype, dbias (nH, n, n) fp32 summed over all B_
    windows."""
    _check_lane_window(x3, bias, mask, n_windows, n_heads)
    b_, n, c3 = x3.shape
    (q, k, v), adds = _lane_window_heads(x3, bias, mask, n_windows, n_heads)
    dof = do.reshape(q.shape[0], q.shape[1], n, n_heads, -1).transpose(-2, -3)
    dq, dk, dv, ds = _attend_backward(q, k, v, adds, scale, dof)
    dx3 = torch.stack([dq, dk, dv]).permute(1, 2, 4, 0, 3, 5).reshape(b_, n, c3)
    return dx3, ds.sum((0, 1))


def _lane_window_fwd(x3, bias, mask, n_windows, n_heads, scale):
    tensors = (x3, bias) if mask is None else (x3, bias, mask)
    if any(t.dtype != torch.float32 for t in tensors[1:]):
        raise TypeError("bias and mask must be float32")
    dev = _build.check_tensors(*tensors)
    code = _build.dtype_code(x3.dtype)
    b_, n, c3 = x3.shape
    c = c3 // 3
    lib = _build.library()
    _build.check_smem(lib.emvm_window_attention_fwd_smem_bytes(code, n, c // n_heads),
                      f"a window of {n} tokens")
    out = torch.empty((b_, n, c), dtype=x3.dtype, device=dev)
    with torch.cuda.device(dev):
        _build.record_launch(lib.emvm_lane_window_attention_fwd(
            code, x3.data_ptr(), bias.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), b_, n, c, n_heads, n_windows,
            _scale_in(x3.dtype, scale), _build.stream_ptr(dev)), "lane_window_attention")
    return out


def _window_bwd_body(dtype: torch.dtype, hd: int) -> str:
    """The body of the window-attention backward (rows 4, 8, 9 and 10) that
    a launch runs, by the rule of the C entry points: bf16 at hd 32 (every
    Swin's head) on the tensor cores (``csrc/attention_bwd_mma.cuh``), fp32
    and bf16 at any other hd on the CUDA cores (``csrc/attention_bwd.cuh``)."""
    return "tensor_core" if dtype == torch.bfloat16 and hd == 32 else "cuda_core"


def _lane_window_bwd(x3, bias, mask, do, n_windows, n_heads, scale):
    tensors = (x3, bias, do) if mask is None else (x3, bias, do, mask)
    if any(t.dtype != torch.float32 for t in (bias, mask) if t is not None):
        raise TypeError("bias and mask must be float32")
    dev = _build.check_tensors(*tensors)
    if do.dtype != x3.dtype:
        raise TypeError(f"do is {do.dtype}, x3 {x3.dtype}")
    code = _build.dtype_code(x3.dtype)
    b_, n, c3 = x3.shape
    c = c3 // 3
    if do.shape != (b_, n, c):
        raise ValueError(f"do must be {(b_, n, c)}, got {tuple(do.shape)}")
    nw = n_windows if mask is not None else 1
    lib = _build.library()
    _build.check_smem(lib.emvm_lane_window_attention_bwd_smem_bytes(code, n, c // n_heads),
                      f"the backward of a window of {n} tokens")
    dx3 = torch.empty_like(x3)
    dbias = torch.empty((n_heads, n, n), dtype=torch.float32, device=dev)
    part = torch.empty(lib.emvm_lane_window_attention_bwd_scratch(b_, n, n_heads, nw),
                       dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _build.record_launch(lib.emvm_lane_window_attention_bwd(
            code, x3.data_ptr(), bias.data_ptr(), None if mask is None else mask.data_ptr(),
            do.data_ptr(), dx3.data_ptr(), dbias.data_ptr(), part.data_ptr(), b_, n, c,
            n_heads, nw, _scale_in(x3.dtype, scale), _scale_f32(scale),
            _build.stream_ptr(dev)), "lane_window_attention_bwd")
    return dx3, dbias


class _LaneWindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x3, bias, mask, n_windows, n_heads, scale):
        _check_lane_window(x3, bias, mask, n_windows, n_heads)
        ctx.save_for_backward(x3, bias, mask)
        ctx.config = (n_windows, n_heads, scale)
        if x3.device.type == "cpu":
            return lane_window_attention_reference(x3, bias, mask, n_windows, n_heads, scale)
        return _lane_window_fwd(x3, bias, mask, n_windows, n_heads, scale)

    @staticmethod
    def backward(ctx, do):
        x3, bias, mask = ctx.saved_tensors
        if x3.device.type == "cpu":
            dx3, dbias = lane_window_attention_backward_plain(x3, bias, mask, do, *ctx.config)
        else:
            dx3, dbias = _lane_window_bwd(x3, bias, mask, do.contiguous(), *ctx.config)
        return dx3, dbias, None, None, None, None


def lane_window_attention(x3: torch.Tensor, bias: torch.Tensor, mask: torch.Tensor | None,
                          n_windows: int, n_heads: int, scale: float) -> torch.Tensor:
    """Window attention on partitioned windows (JAX ``lane_window_attention``),
    differentiable in x3 and bias. The JAX ``t_slices=f`` form, f frames
    folded into one window that each attend only within themselves, is this
    function on the frames' own windows (partitioned with a window one frame
    deep).

    Args:
      x3:   (B_, n, 3C) qkv output of the partitioned windows, last axis
            ordered (3, nH, hd).
      bias: (nH, n, n) fp32 relative-position bias.
      mask: (nW, n, n) fp32 shift mask, window b_ taking ``mask[b_ % nW]``,
            or None for an unshifted block. It gets no gradient.
    Returns:
      (B_, n, C) in x3's dtype.
    """
    return _LaneWindowAttention.apply(x3, bias, mask, int(n_windows), n_heads, float(scale))


# ---------------------------------------------------------------------------
# lane_attention (tools/lanebench.py's kernel)
# ---------------------------------------------------------------------------

def _check_lane_attention(x3, bias, mask, n_heads):
    if x3.dim() != 3:
        raise ValueError(f"x3 must be (B_, N, 3C), got {tuple(x3.shape)}")
    b_, n, c3 = x3.shape
    if c3 % 3 or (c3 // 3) % n_heads:
        raise ValueError(f"last axis {c3} is not (3, {n_heads}, hd)")
    if bias.shape != (n_heads, n, n):
        raise ValueError(f"bias must be {(n_heads, n, n)}, got {tuple(bias.shape)}")
    if mask.dim() != 3 or mask.shape[1:] != (n, n) or b_ % mask.shape[0]:
        raise ValueError(f"mask must be (nW, {n}, {n}) with nW dividing {b_}, "
                         f"got {tuple(mask.shape)}")


def lane_attention_reference(x3, bias, mask, n_heads, scale):
    """Plain version of :func:`lane_attention` with the roundings of the
    JAX ``_lane_kernel``: the fp32 product q.k, then times the fp32 scale,
    plus bias[h] and mask[b_ % nW]; fp32 softmax; probabilities cast to v's
    dtype before P.V, which sums in fp32; each head's output cast to x3's
    dtype."""
    _check_lane_attention(x3, bias, mask, n_heads)
    b_, n, c3 = x3.shape
    nw = mask.shape[0]
    q, k, v = x3.reshape(b_ // nw, nw, n, 3, n_heads, -1).permute(3, 0, 1, 4, 2, 5)
    s = (q.float() @ k.float().transpose(-1, -2)) * torch.tensor(_scale_f32(scale))
    s = s + bias + mask[:, None]
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = (p.float() @ v.float()).to(x3.dtype)
    return o.transpose(-2, -3).reshape(b_, n, c3 // 3)


def _lane_attention_fwd(x3, bias, mask, n_heads, scale):
    if bias.dtype != torch.float32 or mask.dtype != torch.float32:
        raise TypeError("bias and mask must be float32")
    dev = _build.check_tensors(x3, bias, mask)
    code = _build.dtype_code(x3.dtype)
    b_, n, c3 = x3.shape
    c = c3 // 3
    lib = _build.library()
    _build.check_smem(lib.emvm_window_attention_fwd_smem_bytes(code, n, c // n_heads),
                      f"a window of {n} tokens")
    out = torch.empty((b_, n, c), dtype=x3.dtype, device=dev)
    with torch.cuda.device(dev):
        _build.record_launch(lib.emvm_lane_attention_fwd(
            code, x3.data_ptr(), bias.data_ptr(), mask.data_ptr(), out.data_ptr(), b_, n, c,
            n_heads, mask.shape[0], _scale_f32(scale), _build.stream_ptr(dev)),
            "lane_attention")
    return out


def lane_attention(x3: torch.Tensor, bias: torch.Tensor, mask: torch.Tensor, n_heads: int,
                   scale: float) -> torch.Tensor:
    """Window attention off the (B_, N, 3C) qkv GEMM output, the
    benchmark tool's kernel (``tools/lanebench.py`` ``lane_attention``),
    forward only as there. Unlike :func:`lane_window_attention` it scales
    the fp32 scores, not q, and always takes a mask.

    Args:
      x3:   (B_, N, 3C), last axis ordered (3, nH, hd).
      bias: (nH, N, N) fp32.
      mask: (nW, N, N) fp32, window b_ taking ``mask[b_ % nW]``; nW = 1
            applies one mask to every window.
    Returns:
      (B_, N, C) in x3's dtype. A CPU tensor takes the plain version; a
      CUDA tensor launches the kernel.
    """
    _check_lane_attention(x3, bias, mask, n_heads)
    if x3.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("lane_attention is forward only, as in the JAX package; for a "
                           "gradient take lane_window_attention (rows 7 and 8), as the "
                           "tool's --grad does")
    if x3.device.type == "cpu":
        return lane_attention_reference(x3, bias, mask, n_heads, scale)
    return _lane_attention_fwd(x3, bias, mask, n_heads, scale)


# ---------------------------------------------------------------------------
# packed_window_attention and fused_window_attention
# ---------------------------------------------------------------------------

def _check_packed(qkv, bias, mask, n_windows, n_heads):
    if qkv.dim() != 4 or qkv.shape[1] != 3 * n_heads:
        raise ValueError(f"qkv must be (B_, 3*{n_heads}, N, hd), got {tuple(qkv.shape)}")
    _check_tiles(qkv.shape[0], n_heads, qkv.shape[2], bias, mask, n_windows)


def _check_tiles(b_, n_heads, n, bias, mask, n_windows):
    if bias.shape != (n_heads, n, n):
        raise ValueError(f"bias must be {(n_heads, n, n)}, got {tuple(bias.shape)}")
    if mask is not None:
        if n_windows < 1 or b_ % n_windows:
            raise ValueError(f"{b_} windows are not a multiple of n_windows={n_windows}")
        if mask.shape != (n_windows, n, n):
            raise ValueError(f"mask must be {(n_windows, n, n)}, got {tuple(mask.shape)}")


def _tile_heads(t, nw):
    """(B_, X, N, hd) as (B_/nW, nW, X, N, hd): window b_ = (period, b_ % nW)."""
    return t.reshape(t.shape[0] // nw, nw, *t.shape[1:])


def _tile_adds(bias, mask):
    return [bias] if mask is None else [bias, mask[:, None]]


def _tiles_attend(q, k, v, bias, mask, n_windows, scale):
    nw = n_windows if mask is not None else 1
    o = _attend(*(_tile_heads(t, nw) for t in (q, k, v)), _tile_adds(bias, mask), scale)
    return o.reshape(q.shape)


def _tiles_attend_backward(q, k, v, bias, mask, do, n_windows, scale):
    nw = n_windows if mask is not None else 1
    dq, dk, dv, ds = _attend_backward(*(_tile_heads(t, nw) for t in (q, k, v)),
                                      _tile_adds(bias, mask), scale, _tile_heads(do, nw))
    return dq.reshape(q.shape), dk.reshape(q.shape), dv.reshape(q.shape), ds.sum((0, 1))


def packed_window_attention_plain(qkv, bias, mask, n_windows, n_heads, scale):
    """Plain version of :func:`packed_window_attention`, with the kernel's
    roundings (:func:`_attend`)."""
    _check_packed(qkv, bias, mask, n_windows, n_heads)
    return _tiles_attend(*qkv.chunk(3, dim=1), bias, mask, n_windows, scale)


def packed_window_attention_backward_plain(qkv, bias, mask, do, n_windows, n_heads, scale):
    """Plain backward of :func:`packed_window_attention` with the algebra and
    roundings of the JAX ``_attn_bwd_kernel`` (:func:`_attend_backward`):
    dqkv (B_, 3nH, N, hd) in qkv's dtype, dbias (nH, N, N) fp32 summed over
    all B_ windows."""
    _check_packed(qkv, bias, mask, n_windows, n_heads)
    dq, dk, dv, dbias = _tiles_attend_backward(*qkv.chunk(3, dim=1), bias, mask, do,
                                               n_windows, scale)
    return torch.cat([dq, dk, dv], dim=1), dbias


def _tiles_launch_args(q, bias, mask, n_windows):
    """Checks common to the packed kernel's launches (q's storage is checked
    by the caller: q may be a view into qkv); returns the library, the dtype
    code, the device and nW as the kernel takes it."""
    if any(t.dtype != torch.float32 for t in (bias, mask) if t is not None):
        raise TypeError("bias and mask must be float32")
    dev = _build.check_tensors(*(t for t in (bias, mask) if t is not None))
    if q.device != dev:
        raise ValueError(f"tensors on {q.device} and {dev}")
    code = _build.dtype_code(q.dtype)
    return _build.library(), code, dev, (n_windows if mask is not None else 1)


def _tiles_fwd(q, k, v, window_stride, b_, n_heads, bias, mask, n_windows, scale, name):
    """Launch the packed forward on q, k, v bases (views of contiguous
    storage, their windows ``window_stride`` elements apart)."""
    lib, code, dev, nw = _tiles_launch_args(q, bias, mask, n_windows)
    n, hd = q.shape[-2:]
    _build.check_smem(lib.emvm_window_attention_fwd_smem_bytes(code, n, hd),
                      f"a window of {n} tokens")
    out = torch.empty((b_, n_heads, n, hd), dtype=q.dtype, device=dev)
    with torch.cuda.device(dev):
        _build.record_launch(lib.emvm_packed_window_attention_fwd(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(), window_stride, bias.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(), b_, n, n_heads, hd, nw,
            _scale_in(q.dtype, scale), _build.stream_ptr(dev)), name)
    return out


def _tiles_bwd(q, k, v, dq, dk, dv, window_stride, b_, n_heads, bias, mask, do, n_windows,
               scale, name):
    """Launch the packed backward; dq, dk, dv are written in the layout of
    q, k, v. Returns dbias."""
    lib, code, dev, nw = _tiles_launch_args(q, bias, mask, n_windows)
    n, hd = q.shape[-2:]
    if _build.check_tensors(do) != dev:
        raise ValueError(f"tensors on {do.device} and {dev}")
    if do.dtype != q.dtype:
        raise TypeError(f"do is {do.dtype}, q {q.dtype}")
    if do.shape != (b_, n_heads, n, hd):
        raise ValueError(f"do must be {(b_, n_heads, n, hd)}, got {tuple(do.shape)}")
    _build.check_smem(lib.emvm_packed_window_attention_bwd_smem_bytes(code, n, hd),
                      f"the backward of a window of {n} tokens")
    dbias = torch.empty((n_heads, n, n), dtype=torch.float32, device=dev)
    part = torch.empty(lib.emvm_packed_window_attention_bwd_scratch(b_, n, n_heads, nw),
                       dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _build.record_launch(lib.emvm_packed_window_attention_bwd(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), window_stride, bias.data_ptr(),
            None if mask is None else mask.data_ptr(), do.data_ptr(), dbias.data_ptr(),
            part.data_ptr(), b_, n, n_heads, hd, nw, _scale_in(q.dtype, scale),
            _scale_f32(scale), _build.stream_ptr(dev)), name)
    return dbias


def _packed_fwd(qkv, bias, mask, n_windows, n_heads, scale):
    _build.check_tensors(qkv)
    b_ = qkv.shape[0]
    return _tiles_fwd(*qkv.chunk(3, dim=1), qkv[0].numel(), b_, n_heads, bias, mask,
                      n_windows, scale, "packed_window_attention")


def _packed_bwd(qkv, bias, mask, do, n_windows, n_heads, scale):
    _build.check_tensors(qkv)
    dqkv = torch.empty_like(qkv)
    dbias = _tiles_bwd(*qkv.chunk(3, dim=1), *dqkv.chunk(3, dim=1), qkv[0].numel(),
                       qkv.shape[0], n_heads, bias, mask, do, n_windows, scale,
                       "packed_window_attention_bwd")
    return dqkv, dbias


class _PackedWindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, bias, mask, n_windows, n_heads, scale):
        _check_packed(qkv, bias, mask, n_windows, n_heads)
        ctx.save_for_backward(qkv, bias, mask)
        ctx.config = (n_windows, n_heads, scale)
        if qkv.device.type == "cpu":
            return packed_window_attention_plain(qkv, bias, mask, n_windows, n_heads, scale)
        return _packed_fwd(qkv, bias, mask, n_windows, n_heads, scale)

    @staticmethod
    def backward(ctx, do):
        qkv, bias, mask = ctx.saved_tensors
        if qkv.device.type == "cpu":
            dqkv, dbias = packed_window_attention_backward_plain(qkv, bias, mask, do,
                                                                 *ctx.config)
        else:
            dqkv, dbias = _packed_bwd(qkv, bias, mask, do.contiguous(), *ctx.config)
        return dqkv, dbias, None, None, None, None


def packed_window_attention(qkv: torch.Tensor, bias: torch.Tensor, mask: torch.Tensor | None,
                            n_windows: int, n_heads: int, scale: float) -> torch.Tensor:
    """Window attention on the packed qkv tensor (JAX
    ``packed_window_attention``), differentiable in qkv and bias.

    Args:
      qkv:  (B_, 3nH, N, hd), the qkv GEMM output of the partitioned windows
            reshaped to (B_, N, 3nH, hd) and transposed once; axis 1 ordered
            (3, nH).
      bias: (nH, N, N) fp32 relative-position bias.
      mask: (nW, N, N) fp32 shift mask, window b_ taking ``mask[b_ % nW]``,
            or None for an unshifted block (the JAX ``has_mask=False``). It
            gets no gradient.
    Returns:
      (B_, nH, N, hd) in qkv's dtype.
    """
    return _PackedWindowAttention.apply(qkv, bias, mask, int(n_windows), int(n_heads),
                                        float(scale))


def _check_fused(q, k, v, bias, mask, n_windows):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be (B_, nH, N, hd) alike, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if mask is None:
        raise ValueError("fused_window_attention always adds its mask")
    _check_tiles(q.shape[0], q.shape[1], q.shape[2], bias, mask, n_windows)


def fused_window_attention_plain(q, k, v, bias, mask, n_windows, scale):
    """Plain version of :func:`fused_window_attention`."""
    _check_fused(q, k, v, bias, mask, n_windows)
    return _tiles_attend(q, k, v, bias, mask, n_windows, scale)


def fused_window_attention_backward_plain(q, k, v, bias, mask, do, n_windows, scale):
    """Plain backward of :func:`fused_window_attention`: dq, dk, dv in q's
    dtype, dbias (nH, N, N) fp32."""
    _check_fused(q, k, v, bias, mask, n_windows)
    return _tiles_attend_backward(q, k, v, bias, mask, do, n_windows, scale)


def _fused_fwd(q, k, v, bias, mask, n_windows, scale):
    _build.check_tensors(q, k, v)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v are {q.dtype}, {k.dtype}, {v.dtype}")
    return _tiles_fwd(q, k, v, q[0].numel(), q.shape[0], q.shape[1], bias, mask, n_windows,
                      scale, "fused_window_attention")


def _fused_bwd(q, k, v, bias, mask, do, n_windows, scale):
    _build.check_tensors(q, k, v)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v are {q.dtype}, {k.dtype}, {v.dtype}")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dbias = _tiles_bwd(q, k, v, dq, dk, dv, q[0].numel(), q.shape[0], q.shape[1], bias, mask,
                       do, n_windows, scale, "fused_window_attention_bwd")
    return dq, dk, dv, dbias


class _FusedWindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, mask, n_windows, scale):
        _check_fused(q, k, v, bias, mask, n_windows)
        ctx.save_for_backward(q, k, v, bias, mask)
        ctx.config = (n_windows, scale)
        if q.device.type == "cpu":
            return fused_window_attention_plain(q, k, v, bias, mask, n_windows, scale)
        return _fused_fwd(q, k, v, bias, mask, n_windows, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, mask = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = fused_window_attention_backward_plain(q, k, v, bias, mask, do, *ctx.config)
        else:
            grads = _fused_bwd(q, k, v, bias, mask, do.contiguous(), *ctx.config)
        return (*grads, None, None, None)


def fused_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, mask: torch.Tensor, n_windows: int,
                           scale: float) -> torch.Tensor:
    """Window attention on q, k and v held as three arrays (JAX
    ``fused_window_attention``), differentiable in q, k, v and bias; the
    kernel of :func:`packed_window_attention` on three base pointers.

    Args:
      q, k, v: (B_, nH, N, hd), windows innermost in B_.
      bias:    (nH, N, N) fp32 relative-position bias.
      mask:    (nW, N, N) fp32 additive mask, always added, window b_ taking
               ``mask[b_ % nW]``. It gets no gradient.
    Returns:
      (B_, nH, N, hd) in q's dtype.
    """
    return _FusedWindowAttention.apply(q, k, v, bias, mask, int(n_windows), float(scale))


# ---------------------------------------------------------------------------
# The BERT route: lane_self_attention where it fits, else the tiled kernel
# ---------------------------------------------------------------------------

# The JAX package's default VMEM budget for one lane program
# (``_lane_budget``: ``EMVM_LANE_BUDGET_MB`` unset)
LANE_BUDGET_BYTES = 10 * 2 ** 20


def _lane_sa_bytes(n: int, c: int) -> int:
    """The JAX ``_lane_bytes(1, n, c, nh, backward=True, with_bias=False)``:
    one lane self-attention program's VMEM estimate in bf16 (double-buffered
    x3, do and dx3 blocks, the streamed fp32 mask, four live fp32 (N, N)
    temporaries, the per-head outputs)."""
    item = 2
    inb = 4 * n * c * item * 2
    outb = n * 3 * c * item * 2
    maskb = n * n * 4 * 2
    temps = 4 * n * n * 4
    acc = 3 * n * c * item
    return inb + outb + maskb + temps + acc


def lane_sa_attention_fits(b: int, l: int, c: int, nh: int) -> bool:
    """The JAX ``lane_sa_attention_fits``: BERT runs :func:`lane_self_attention`
    when the width is a multiple of 128 and one lane program's backward fits
    the JAX budget, else :func:`packed_self_attention`. It reads (b, l, c,
    nh) only, whatever the dtype, so both packages route a model alike: the
    fusion over 232 (pretrain) and 275 (retrieval) tokens takes the lane
    kernel, the multiple-choice fusion over 350 tokens the tiled one."""
    return c % 128 == 0 and _lane_sa_bytes(l, c) <= LANE_BUDGET_BYTES


def vit_self_attention(qkv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Unmasked self-attention of a frozen ViT (p = 0, a zero mask), routed
    as the JAX teachers route it: :func:`lane_self_attention` off the fused
    qkv where :func:`lane_sa_attention_fits`, else the transposed heads
    through :func:`packed_self_attention`. qkv (B, L, 3D), last axis ordered
    (3, nH, hd); returns (B, L, D) in qkv's dtype."""
    b, l, c3 = qkv.shape
    d = c3 // 3
    hd = d // n_heads
    zeros = torch.zeros((1, 1, l), dtype=torch.float32, device=qkv.device).expand(b, l, l)
    if lane_sa_attention_fits(b, l, d, n_heads):
        return lane_self_attention(qkv, zeros, n_heads, hd ** -0.5)
    qkv = qkv.reshape(b, l, 3 * n_heads, hd).transpose(1, 2).contiguous()
    ctx = packed_self_attention(qkv, zeros, n_heads, hd ** -0.5)
    return ctx.transpose(1, 2).reshape(b, l, d)


# ---------------------------------------------------------------------------
# packed_self_attention and fused_self_attention
# ---------------------------------------------------------------------------

# hd up to 128: the CUDA-core body holds up to 4 channels a lane
# (csrc/self_attention_tiled.cu kMaxHd); the tensor-core body takes
# TENSOR_CORE_HDS
MAX_TILED_HD = 128
TENSOR_CORE_HDS = (32, 64, 128)


def _sa_body(dtype: torch.dtype, hd: int) -> str:
    """The body of the tiled kernel that a launch runs, by the rule its C
    entry points apply: bf16 at hd 32, 64 or 128 on the tensor cores
    (``csrc/self_attention_mma.cuh``); fp32, whose limits need fp32
    products, and bf16 at any other hd on the CUDA cores."""
    return "tensor_core" if dtype == torch.bfloat16 and hd in TENSOR_CORE_HDS else "cuda_core"


def _check_sa(b, n, mask, p_drop, seed):
    if mask.shape != (b, n, n):
        raise ValueError(f"mask must be {(b, n, n)}, got {tuple(mask.shape)}")
    _check_drop(p_drop, seed)


def _check_packed_sa(qkv, mask, n_heads, p_drop, seed):
    if qkv.dim() != 4 or qkv.shape[1] != 3 * n_heads:
        raise ValueError(f"qkv must be (B, 3*{n_heads}, N, hd), got {tuple(qkv.shape)}")
    _check_sa(qkv.shape[0], qkv.shape[2], mask, p_drop, seed)


def _check_fused_sa(q, k, v, mask, p_drop, seed):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be (B, nH, N, hd) alike, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    _check_sa(q.shape[0], q.shape[2], mask, p_drop, seed)


def _sa_keep(q, p_drop, seed):
    if p_drop == 0.0:
        return None
    b, nh, n, _ = q.shape
    return dropout_keep(seed, (b, nh, n, n), p_drop)


def _sa_attend(q, k, v, mask, scale, p_drop, seed):
    return _attend(q, k, v, [mask[:, None]], scale, _sa_keep(q, p_drop, seed),
                   _inv_keep(p_drop))


def _sa_attend_backward(q, k, v, mask, do, scale, p_drop, seed):
    return _attend_backward(q, k, v, [mask[:, None]], scale, do, _sa_keep(q, p_drop, seed),
                            _inv_keep(p_drop))[:3]


def packed_self_attention_plain(qkv, mask, n_heads, scale, p_drop=0.0, seed=None):
    """Plain version of :func:`packed_self_attention`'s forward; ``seed`` is
    the (seed, offset) int32 pair the kernel would be given."""
    _check_packed_sa(qkv, mask, n_heads, p_drop, seed)
    return _sa_attend(*qkv.chunk(3, dim=1), mask, scale, p_drop, seed)


def packed_self_attention_backward_plain(qkv, mask, do, n_heads, scale, p_drop=0.0, seed=None):
    """Plain backward of :func:`packed_self_attention`: dqkv (B, 3nH, N, hd)
    in qkv's dtype, regenerating the forward's keep mask."""
    _check_packed_sa(qkv, mask, n_heads, p_drop, seed)
    return torch.cat(_sa_attend_backward(*qkv.chunk(3, dim=1), mask, do, scale, p_drop, seed),
                     dim=1)


def fused_self_attention_plain(q, k, v, mask, scale, p_drop=0.0, seed=None):
    """Plain version of :func:`fused_self_attention`'s forward."""
    _check_fused_sa(q, k, v, mask, p_drop, seed)
    return _sa_attend(q, k, v, mask, scale, p_drop, seed)


def fused_self_attention_backward_plain(q, k, v, mask, do, scale, p_drop=0.0, seed=None):
    """Plain backward of :func:`fused_self_attention`: dq, dk, dv in q's
    dtype."""
    _check_fused_sa(q, k, v, mask, p_drop, seed)
    return _sa_attend_backward(q, k, v, mask, do, scale, p_drop, seed)


def _sa_lib(q, hd, backward):
    """Checks common to the tiled kernel's launches; returns the library
    and the dtype code."""
    if hd > MAX_TILED_HD:
        raise ValueError(f"the tiled self-attention takes hd <= {MAX_TILED_HD}, got {hd}")
    code = _build.dtype_code(q.dtype)
    lib = _build.library()
    _build.check_smem(lib.emvm_tiled_self_attention_smem_bytes(code, hd, int(backward)),
                      f"a head of {hd} channels")
    return lib, code


def _sa_fwd(q, k, v, batch_stride, n_heads, mask, scale, p_drop, seed, name):
    """Launch the tiled forward on q, k, v bases (views of contiguous
    storage, rows b ``batch_stride`` elements apart). Returns out (B, nH, N,
    hd) and the rows' max and sum (B, nH, 2, N) fp32."""
    (mptr, msb, msr), drop = _lane_args(q, mask, seed, p_drop)
    b, _, n, hd = q.shape
    lib, code = _sa_lib(q, hd, False)
    out = torch.empty((b, n_heads, n, hd), dtype=q.dtype, device=q.device)
    stats = torch.empty((b, n_heads, 2, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _build.record_launch(lib.emvm_tiled_self_attention_fwd(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(), batch_stride, mptr, msb, msr,
            out.data_ptr(), stats.data_ptr(), b, n, n_heads, hd, _scale_in(q.dtype, scale),
            *drop, _build.stream_ptr(q.device)), name)
    return out, stats


def _sa_bwd(q, k, v, dq, dk, dv, batch_stride, n_heads, mask, do, stats, scale, p_drop, seed,
            name):
    """Launch the tiled backward from the forward's ``stats``; dq, dk, dv
    are written in the layout of q, k, v."""
    (mptr, msb, msr), drop = _lane_args(q, mask, seed, p_drop)
    if _build.check_tensors(do, stats) != q.device:
        raise ValueError(f"tensors on {do.device} and {q.device}")
    if do.dtype != q.dtype:
        raise TypeError(f"do is {do.dtype}, q {q.dtype}")
    b, _, n, hd = q.shape
    if do.shape != (b, n_heads, n, hd) or stats.shape != (b, n_heads, 2, n):
        raise ValueError(f"do and stats must be {(b, n_heads, n, hd)}, {(b, n_heads, 2, n)}, "
                         f"got {tuple(do.shape)}, {tuple(stats.shape)}")
    lib, code = _sa_lib(q, hd, True)
    dsum = torch.empty((b, n_heads, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _build.record_launch(lib.emvm_tiled_self_attention_bwd(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), batch_stride, mptr, msb, msr, do.data_ptr(), stats.data_ptr(),
            dsum.data_ptr(), b, n, n_heads, hd, _scale_in(q.dtype, scale), _scale_f32(scale),
            *drop, _build.stream_ptr(q.device)), name)


def _packed_sa_fwd(qkv, mask, n_heads, scale, p_drop, seed):
    _build.check_tensors(qkv)
    return _sa_fwd(*qkv.chunk(3, dim=1), qkv[0].numel(), n_heads, mask, scale, p_drop, seed,
                   "packed_self_attention")


def _packed_sa_bwd(qkv, mask, do, stats, n_heads, scale, p_drop, seed):
    _build.check_tensors(qkv)
    dqkv = torch.empty_like(qkv)
    _sa_bwd(*qkv.chunk(3, dim=1), *dqkv.chunk(3, dim=1), qkv[0].numel(), n_heads, mask, do,
            stats, scale, p_drop, seed, "packed_self_attention_bwd")
    return dqkv


def _fused_sa_fwd(q, k, v, mask, scale, p_drop, seed):
    _build.check_tensors(q, k, v)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v are {q.dtype}, {k.dtype}, {v.dtype}")
    return _sa_fwd(q, k, v, q[0].numel(), q.shape[1], mask, scale, p_drop, seed,
                   "fused_self_attention")


def _fused_sa_bwd(q, k, v, mask, do, stats, scale, p_drop, seed):
    _build.check_tensors(q, k, v)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    _sa_bwd(q, k, v, dq, dk, dv, q[0].numel(), q.shape[1], mask, do, stats, scale, p_drop, seed,
            "fused_self_attention_bwd")
    return dq, dk, dv


class _PackedSelfAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, mask, seed, n_heads, scale, p_drop):
        _check_packed_sa(qkv, mask, n_heads, p_drop, seed)
        ctx.config = (n_heads, scale, p_drop)
        if qkv.device.type == "cpu":
            ctx.save_for_backward(qkv, mask, seed)
            return packed_self_attention_plain(qkv, mask, n_heads, scale, p_drop, seed)
        out, stats = _packed_sa_fwd(qkv, mask, n_heads, scale, p_drop, seed)
        ctx.save_for_backward(qkv, mask, seed, stats)
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, mask, seed, *stats = ctx.saved_tensors
        n_heads, scale, p_drop = ctx.config
        if qkv.device.type == "cpu":
            dqkv = packed_self_attention_backward_plain(qkv, mask, do, n_heads, scale, p_drop,
                                                        seed)
        else:
            dqkv = _packed_sa_bwd(qkv, mask, do.contiguous(), *stats, n_heads, scale, p_drop,
                                  seed)
        return dqkv, None, None, None, None, None


def packed_self_attention(qkv: torch.Tensor, mask: torch.Tensor, n_heads: int, scale: float,
                          p_drop: float = 0.0,
                          generator: torch.Generator | None = None) -> torch.Tensor:
    """BERT self-attention on the packed qkv tensor (JAX
    ``packed_self_attention``), differentiable in qkv, for any sequence
    length.

    Args:
      qkv:  (B, 3nH, N, hd), the fused qkv GEMM output (B, N, 3D) reshaped to
            (B, N, 3nH, hd) and transposed once; axis 1 ordered (3, nH).
      mask: (B, N, N) fp32 additive bias. It may be a broadcast view (for
            example a (B, 1, 1, N) padding bias expanded over the query
            rows); only its key axis must be contiguous. It gets no gradient.
      p_drop: attention-probability dropout rate; above 0 it needs
            ``generator``, from which the call draws its (seed, offset).
    Returns:
      (B, nH, N, hd) in qkv's dtype.
    """
    return _PackedSelfAttention.apply(qkv, mask, _call_seed(p_drop, generator), int(n_heads),
                                      float(scale), float(p_drop))


class _FusedSelfAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, seed, scale, p_drop):
        _check_fused_sa(q, k, v, mask, p_drop, seed)
        ctx.config = (scale, p_drop)
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v, mask, seed)
            return fused_self_attention_plain(q, k, v, mask, scale, p_drop, seed)
        out, stats = _fused_sa_fwd(q, k, v, mask, scale, p_drop, seed)
        ctx.save_for_backward(q, k, v, mask, seed, stats)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, seed, *stats = ctx.saved_tensors
        scale, p_drop = ctx.config
        if q.device.type == "cpu":
            grads = fused_self_attention_backward_plain(q, k, v, mask, do, scale, p_drop, seed)
        else:
            grads = _fused_sa_bwd(q, k, v, mask, do.contiguous(), *stats, scale, p_drop, seed)
        return (*grads, None, None, None, None)


def fused_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                         scale: float, p_drop: float = 0.0,
                         generator: torch.Generator | None = None) -> torch.Tensor:
    """:func:`packed_self_attention` on q, k and v held as three arrays (JAX
    ``fused_self_attention``), differentiable in q, k and v; the same kernel
    on three base pointers.

    Args:
      q, k, v: (B, nH, N, hd).
      mask:    (B, N, N) fp32 additive bias (a view with a contiguous key axis
               will do). It gets no gradient.
    Returns:
      (B, nH, N, hd) in q's dtype.
    """
    return _FusedSelfAttention.apply(q, k, v, mask, _call_seed(p_drop, generator),
                                     float(scale), float(p_drop))
