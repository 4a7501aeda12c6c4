"""Window attention and BERT self-attention: CUDA kernels and plain versions.

Counterpart of ``empirical_mvm_tpu/ops/window_attention.py`` for the two
forward kernels the retrieval eval runs:

* :func:`direct_window_attention` (``csrc/window_attention.cu``) replaces the
  Pallas ``_direct_fwd_kernel``: shifted-window attention read straight from
  the qkv GEMM output in the 5D feature-map layout (every student swin
  block).
* :func:`lane_self_attention` (``csrc/self_attention.cu``) replaces the
  Pallas ``_lane_sa_fwd_kernel`` without dropout: BERT attention read
  straight from the fused qkv output (every fusion layer).

Each wrapper takes its plain version for a CPU tensor and launches its
kernel for a CUDA tensor. The plain versions repeat the kernels' rounding
(q scaled in the input dtype, fp32 scores and softmax, probabilities cast to
v's dtype before P.V); :func:`window_attention_reference` is the JAX
package's own XLA oracle.
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


def _attend(q, k, v, adds, scale):
    """softmax(q*scale . k^T + sum(adds)) . v with the kernels' rounding.
    q, k, v (..., N, hd); adds: fp32 terms broadcastable to (..., N, N)."""
    qs = q * _scale_in(q.dtype, scale)
    s = qs.float() @ k.float().transpose(-1, -2)
    for a in adds:
        s = s + a
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return (p.float() @ v.float()).to(q.dtype)


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


def direct_window_attention_plain(x3, bias, mask, window_eff, n_heads, scale):
    """Plain version of :func:`direct_window_attention`: partition, attend,
    reverse."""
    _check_direct(x3, bias, mask, window_eff, n_heads)
    b, d, hp, wp, c3 = x3.shape
    c = c3 // 3
    hd = c // n_heads
    xw = window_partition(x3, window_eff)                    # (B*nW, N, 3C)
    b_, n, _ = xw.shape
    qkv = xw.reshape(b_, n, 3, n_heads, hd).permute(2, 0, 3, 1, 4)
    adds = [bias[None]]
    if mask is not None:
        nw = mask.shape[0]
        adds.append(mask[None, :, None].expand(b, nw, n_heads, n, n)
                    .reshape(b_, n_heads, n, n))
    o = _attend(qkv[0], qkv[1], qkv[2], adds, scale)          # (B_, nH, N, hd)
    o = o.transpose(1, 2).reshape(b_, n, c)
    return window_reverse(o, window_eff, b, d, hp, wp)


def direct_window_attention(x3: torch.Tensor, bias: torch.Tensor,
                            mask: torch.Tensor | None,
                            window_eff: Sequence[int], n_heads: int,
                            scale: float) -> torch.Tensor:
    """Window attention on the native 5D layout (JAX
    ``direct_window_attention``, forward).

    Args:
      x3:   (B, D, Hp, Wp, 3C) qkv output on the padded, rolled feature map,
            last axis ordered (3, nH, hd); D must equal window_eff[0].
      bias: (nH, N, N) fp32 relative-position bias, N = wd*wh*ww.
      mask: (nW, N, N) fp32 shift mask, windows row-major (h-strip, w), or
            None for an unshifted block.
    Returns:
      (B, D, Hp, Wp, C) in x3's dtype.
    """
    if x3.device.type == "cpu":
        return direct_window_attention_plain(x3, bias, mask, window_eff,
                                             n_heads, scale)
    _check_direct(x3, bias, mask, window_eff, n_heads)
    tensors = (x3, bias) if mask is None else (x3, bias, mask)
    if any(t.dtype != torch.float32 for t in tensors[1:]):
        raise TypeError("bias and mask must be float32")
    dev = _build.check_tensors(*tensors)
    code = _build.dtype_code(x3.dtype)
    b, d, hp, wp, c3 = x3.shape
    wd, wh, ww = window_eff
    c = c3 // 3
    lib = _build.library()
    smem = lib.emvm_attention_smem_bytes(code, wd * wh * ww, c // n_heads)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"window of {wd * wh * ww} tokens needs {smem} bytes "
                         f"of shared memory, above {_build.MAX_SMEM_BYTES}")
    out = torch.empty((b, d, hp, wp, c), dtype=x3.dtype, device=dev)
    with torch.cuda.device(dev):
        _build.record_launch(lib.emvm_direct_window_attention_fwd(
            code, x3.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            b, d, hp, wp, c, n_heads, wh, ww, _scale_in(x3.dtype, scale),
            _build.stream_ptr(dev)), "direct_window_attention")
    return out


def _check_lane(x3, mask, n_heads, p_drop):
    b, l, c3 = x3.shape
    if c3 % 3 or (c3 // 3) % n_heads:
        raise ValueError(f"last axis {c3} is not (3, {n_heads}, hd)")
    if mask.shape != (b, l, l):
        raise ValueError(f"mask must be {(b, l, l)}, got {tuple(mask.shape)}")
    if p_drop > 0.0:
        raise NotImplementedError("attention-probability dropout is not ported "
                                  "yet (it comes with the training kernels)")


def lane_self_attention_plain(x3, mask, n_heads, scale, p_drop=0.0):
    """Plain version of :func:`lane_self_attention`."""
    _check_lane(x3, mask, n_heads, p_drop)
    b, l, c3 = x3.shape
    c = c3 // 3
    qkv = x3.reshape(b, l, 3, n_heads, c // n_heads).permute(2, 0, 3, 1, 4)
    o = _attend(qkv[0], qkv[1], qkv[2], [mask[:, None]], scale)
    return o.transpose(1, 2).reshape(b, l, c)


def lane_self_attention(x3: torch.Tensor, mask: torch.Tensor, n_heads: int,
                        scale: float, p_drop: float = 0.0) -> torch.Tensor:
    """BERT self-attention off the fused qkv output (JAX
    ``lane_self_attention``, forward, no dropout).

    Args:
      x3:   (B, L, 3D), last axis ordered (3, nH, hd).
      mask: (B, L, L) fp32 additive bias. It may be a broadcast view (for
            example a (B, 1, 1, L) padding bias expanded over the query
            rows); only its key axis must be contiguous.
      p_drop: must be 0; dropout is not ported yet.
    Returns:
      (B, L, D) in x3's dtype.
    """
    if x3.device.type == "cpu":
        return lane_self_attention_plain(x3, mask, n_heads, scale, p_drop)
    _check_lane(x3, mask, n_heads, p_drop)
    if mask.dtype != torch.float32 or mask.stride(2) != 1:
        raise TypeError("mask must be float32 with a contiguous key axis")
    if mask.device != x3.device:
        raise ValueError(f"tensors on {mask.device} and {x3.device}")
    dev = _build.check_tensors(x3)
    code = _build.dtype_code(x3.dtype)
    b, l, c3 = x3.shape
    c = c3 // 3
    lib = _build.library()
    smem = lib.emvm_attention_smem_bytes(code, l, c // n_heads)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"sequence of {l} tokens needs {smem} bytes of shared "
                         f"memory, above {_build.MAX_SMEM_BYTES}")
    out = torch.empty((b, l, c), dtype=x3.dtype, device=dev)
    with torch.cuda.device(dev):
        _build.record_launch(lib.emvm_lane_self_attention_fwd(
            code, x3.data_ptr(), mask.data_ptr(), mask.stride(0), mask.stride(1),
            out.data_ptr(), b, l, c, n_heads, _scale_in(x3.dtype, scale),
            _build.stream_ptr(dev)), "lane_self_attention")
    return out
