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
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wd * wh * ww, c)


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
    roundings (``_direct_bwd_kernel``, ``_lane_sa_bwd_kernel``): p recomputed
    in fp32, dv = round(p_drop)^T.do, dp under the keep mask, ds = p * (dp -
    rowsum(dp * p)), dq = (round(ds).k) * scale (fp32 scale), dk =
    round(ds)^T.qs. Returns dq, dk, dv in q's dtype and ds in fp32."""
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
    _build.check_smem(lib.emvm_attention_smem_bytes(code, wd * wh * ww, c // n_heads),
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
    (mptr, msb, msr), drop = _lane_args(x3, mask, seed, p_drop)
    dev = _build.check_tensors(x3)
    code = _build.dtype_code(x3.dtype)
    b, l, c3 = x3.shape
    c = c3 // 3
    lib = _build.library()
    _build.check_smem(lib.emvm_attention_smem_bytes(code, l, c // n_heads),
                      f"a sequence of {l} tokens")
    out = torch.empty((b, l, c), dtype=x3.dtype, device=dev)
    with torch.cuda.device(dev):
        _build.record_launch(lib.emvm_lane_self_attention_fwd(
            code, x3.data_ptr(), mptr, msb, msr, out.data_ptr(), b, l, c, n_heads,
            _scale_in(x3.dtype, scale), *drop, _build.stream_ptr(dev)),
            "lane_self_attention" if p_drop == 0.0 else "lane_self_attention_dropout")
    return out


def _lane_bwd(x3, mask, do, n_heads, scale, p_drop, seed):
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
    stats = torch.empty((b, n_heads, 3, l), dtype=torch.float32, device=dev)
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
    seed = None
    if p_drop > 0.0:
        if generator is None:
            raise ValueError("attention dropout needs a generator")
        seed = draw_dropout_seed(generator)
    return _LaneSelfAttention.apply(x3, mask, seed, n_heads, scale, float(p_drop))
