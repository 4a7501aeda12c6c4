"""The port's lane window attention and the frozen 2D Swin teacher against
the JAX package on the CPU.

* ``lane_window_attention``'s plain versions (the path a CPU tensor takes),
  forward and backward, against the JAX Pallas kernels run in interpret
  mode (the backward through ``jax.vjp``), in the plain form (t_slices = 1)
  and the t-sliced form (f = 2, 4), shifted and unshifted; fp32 at atol
  1e-5, and bf16 within one bf16 step. The port takes the t-sliced form's
  frames as windows of their own (``_per_frame``); its dx3 goes back through
  ``_from_per_frame`` and dbias, summed over every window, compares as it is.
* ``SwinTransformer3D`` at 2D Swin geometry with fused norms (the teacher)
  against the JAX one with ``EMVM_PALLAS_INTERPRET=1``, so that JAX runs its
  t-sliced lane kernel and its kernel LayerNorm: T = 4 (f = 4), T = 2
  (f = 2) and T = 3 (no fold); the port runs the lane kernel on the
  frames' own windows in each case.

Inputs come from numpy with a seed.
"""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (pins JAX to the CPU)
from tests.torch_threads import torch_threads  # noqa: F401  (the cores' share under xdist)

import jax
import jax.numpy as jnp

from empirical_mvm_tpu.core import config as jcfg
from empirical_mvm_tpu.models.video_swin import SwinTransformer3D as JSwin
from empirical_mvm_tpu.ops import window_attention as jwa
from empirical_mvm_torch.core import config as tcfg
from empirical_mvm_torch.models import convert
from empirical_mvm_torch.models.encoders2d import SWIN2D_SIZES, swin2d_config
from empirical_mvm_torch.models.video_swin import (SwinTransformer3D, WindowAttention3D,
                                                  _shift_attn_mask)
from empirical_mvm_torch.ops import _build
from empirical_mvm_torch.ops import window_attention as twa
from empirical_mvm_torch.ops.layernorm import FusedLayerNorm, LayerNorm
from tests.test_torch_pretrain import drawn_params

T = torch.from_numpy
N, C, NH = 49, 128, 4                    # one 7 x 7 slice, hd = 32
BF16_STEP = 2.0 ** -7                    # one bf16 step, relative


def _lane_inputs(f, n_windows, seed=0):
    rs = np.random.RandomState(seed)
    b_ = 8
    shape = (b_, f, N, 3 * C) if f > 1 else (b_, N, 3 * C)
    x3 = (rs.randn(*shape) * 0.5).astype(np.float32)
    bias = (rs.randn(NH, N, N) * 0.1).astype(np.float32)
    mask = np.where(rs.rand(n_windows, N, N) < 0.3, -100.0, 0.0).astype(np.float32)
    return x3, bias, mask


def _per_frame(x3, n_windows):
    """The JAX t-sliced layout (B_, f, n, X), window b_ taking mask[b_ % nW],
    as the port's windows (B_ * f, n, X): each slice a window of its own,
    ordered (period, slice, window) so that it takes the same mask[b_ % nW]."""
    b_, f, n, x = x3.shape
    return x3.reshape(b_ // n_windows, n_windows, f, n, x).transpose(1, 2).reshape(-1, n, x)


def _from_per_frame(out, n_windows, f):
    """Inverse of :func:`_per_frame`."""
    n, x = out.shape[-2:]
    return out.reshape(-1, f, n_windows, n, x).transpose(1, 2).reshape(-1, f, n, x)


def _port_lane(x3, bias, mask, n_windows, f):
    """The port's lane window attention on the JAX layout of ``x3``."""
    x3 = x3 if f > 1 else x3[:, None]
    nw = n_windows if mask is not None else 1
    out = twa.lane_window_attention(_per_frame(x3, nw), bias, mask, nw, NH, (C // NH) ** -0.5)
    out = _from_per_frame(out, nw, x3.shape[1])
    return out if f > 1 else out[:, 0]


def _jax_lane(x3, bias, mask, n_windows, f, has_mask):
    jmask = mask if has_mask else np.zeros((1, N, N), np.float32)
    return np.asarray(jax.jit(
        lambda a, b, m: jwa.lane_window_attention(a, b, m, n_windows if has_mask else 1, NH,
                                                  (C // NH) ** -0.5, True, has_mask,
                                                  t_slices=f))(
        jnp.asarray(x3), jnp.asarray(bias), jnp.asarray(jmask)).astype(jnp.float32))


@pytest.mark.parametrize("f", [1, 2, 4])
@pytest.mark.parametrize("n_windows,has_mask", [(1, False), (1, True), (4, True)])
def test_lane_window_attention_matches_jax_kernel(f, n_windows, has_mask):
    x3, bias, mask = _lane_inputs(f, n_windows)
    ref = _jax_lane(x3, bias, mask, n_windows, f, has_mask)
    out = _port_lane(T(x3), T(bias), T(mask) if has_mask else None, n_windows, f)
    assert out.shape == x3.shape[:-1] + (C,)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("f", [1, 4])
def test_lane_window_attention_bf16_matches_jax_kernel(f):
    """The plain version run in bf16 repeats the JAX kernel's roundings: the
    outputs agree within one bf16 step. A probability whose bf16 rounding
    falls the other way after another fp32 summation order moves an output
    by a step of one P.V term, which for a small, cancelling output is more
    than a step of the output itself: each element within one step of
    itself or half a step of the largest output, and at most 0.1 % of the
    elements different at all."""
    x3, bias, mask = _lane_inputs(f, 4, seed=1)
    x16 = x3.astype(jnp.bfloat16)
    ref = _jax_lane(x16, bias, mask, 4, f, True)
    out = _port_lane(T(x16.astype(np.float32)).to(torch.bfloat16), T(bias), T(mask), 4, f)
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    np.testing.assert_allclose(out, ref, atol=BF16_STEP / 2 * np.abs(ref).max(),
                               rtol=BF16_STEP)
    assert (out != ref).mean() <= 1e-3


def test_tsliced_lane_equals_each_frame_attended_alone():
    """A frame attends only within itself: the per-frame attention of the
    teacher over 4 frames (the lane kernel on (1, 7, 7) windows with the
    4-frame shift mask) equals each frame run alone (D == wd: the direct
    kernel with one frame's mask)."""
    rs = np.random.RandomState(2)
    attn = WindowAttention3D(C, (1, 7, 7), NH)
    with torch.no_grad():
        for prm in attn.parameters():
            prm.copy_(T(rs.randn(*prm.shape).astype(np.float32) * 0.1))
    x = T(rs.randn(2, 4, 14, 14, C).astype(np.float32))
    win, shift = (1, 7, 7), (0, 3, 3)
    with torch.no_grad():
        for mask in (None, T(_shift_attn_mask((4, 14, 14), win, shift))):
            out = attn(x, mask, win)
            for t in range(4):
                one = None if mask is None else T(_shift_attn_mask((1, 14, 14), win, shift))
                alone = attn(x[:, t:t + 1], one, win)
                torch.testing.assert_close(out[:, t:t + 1], alone, atol=1e-5, rtol=0)


def _lane_bwd_inputs(f, n_windows, dtype=np.float32, seed=0):
    x3, bias, mask = _lane_inputs(f, n_windows, seed)
    rs = np.random.RandomState(seed + 10)
    do = rs.randn(*x3.shape[:-1], C).astype(np.float32)
    return x3.astype(dtype), bias, mask, do.astype(dtype)


def _port_lane_bwd(x3, bias, mask, do, n_windows, f):
    """The port's plain backward on the JAX layout: dx3 back in that layout,
    dbias as it is."""
    x3, do = (x3, do) if f > 1 else (x3[:, None], do[:, None])
    nw = n_windows if mask is not None else 1
    dx3, dbias = twa.lane_window_attention_backward_plain(
        _per_frame(x3, nw), bias, mask, _per_frame(do, nw), nw, NH, (C // NH) ** -0.5)
    dx3 = _from_per_frame(dx3, nw, x3.shape[1])
    return (dx3 if f > 1 else dx3[:, 0]), dbias


def _jax_lane_bwd(x3, bias, mask, do, n_windows, f, has_mask):
    jmask = jnp.asarray(mask if has_mask else np.zeros((1, N, N), np.float32))

    def vjp(a, b, g):
        _, back = jax.vjp(lambda a, b: jwa.lane_window_attention(
            a, b, jmask, n_windows if has_mask else 1, NH, (C // NH) ** -0.5, True, has_mask,
            t_slices=f), a, b)
        return back(g)

    dx3, dbias = jax.jit(vjp)(jnp.asarray(x3), jnp.asarray(bias), jnp.asarray(do))
    return np.asarray(dx3.astype(jnp.float32)), np.asarray(dbias)


@pytest.mark.parametrize("f", [1, 2, 4])
@pytest.mark.parametrize("n_windows,has_mask", [(1, False), (1, True), (4, True)])
def test_lane_window_attention_backward_matches_jax_kernel(f, n_windows, has_mask):
    x3, bias, mask, do = _lane_bwd_inputs(f, n_windows)
    rdx3, rdbias = _jax_lane_bwd(x3, bias, mask, do, n_windows, f, has_mask)
    dx3, dbias = _port_lane_bwd(T(x3), T(bias), T(mask) if has_mask else None, T(do),
                                n_windows, f)
    assert dx3.shape == x3.shape and dbias.shape == (NH, N, N)
    np.testing.assert_allclose(dx3.numpy(), rdx3, atol=1e-5, rtol=0)
    np.testing.assert_allclose(dbias.numpy(), rdbias, atol=1e-5, rtol=0)


@pytest.mark.parametrize("f", [1, 4])
def test_lane_window_attention_backward_bf16_matches_jax_kernel(f):
    """The plain backward in bf16 repeats the JAX kernel's roundings (q *
    scale, p and ds rounded to bf16 before their products): dx3 within one
    bf16 step of itself or half a step of its largest value, as the forward;
    dq and dv with at most 0.1 % of their elements different at all. dk =
    round(ds)^T . qs is held to the one-step limit only: XLA's CPU compiler
    rewrites the interpreted kernel's dot(ds, q * scale) as dot(ds, q) *
    scale, so the JAX reference skips the bf16 rounding of qs there that the
    kernel's text (and the port) makes, and about 40 % of dk's elements
    land one step apart. dbias is fp32 from fp32 ds and differs by
    summation order only."""
    x3, bias, mask, do = _lane_bwd_inputs(f, 4, jnp.bfloat16, seed=1)
    rdx3, rdbias = _jax_lane_bwd(x3, bias, mask, do, 4, f, True)
    bf = lambda a: T(a.astype(np.float32)).to(torch.bfloat16)     # noqa: E731
    dx3, dbias = _port_lane_bwd(bf(x3), T(bias), T(mask), bf(do), 4, f)
    assert dx3.dtype == torch.bfloat16 and dbias.dtype == torch.float32
    dx3 = dx3.float().numpy()
    np.testing.assert_allclose(dx3, rdx3, atol=BF16_STEP / 2 * np.abs(rdx3).max(),
                               rtol=BF16_STEP)
    for part in (slice(0, C), slice(2 * C, 3 * C)):                  # dq, dv
        assert (dx3[..., part] != rdx3[..., part]).mean() <= 1e-3
    np.testing.assert_allclose(dbias.numpy(), rdbias, atol=1e-5 * np.abs(rdbias).max(), rtol=0)


def test_lane_window_wrapper_contract():
    """CPU tensors take the plain versions, forward and backward, and launch
    nothing; the mask gets no gradient; refused shapes raise."""
    x3, bias, mask, do = _lane_bwd_inputs(1, 4)
    before = dict(_build.launch_counts)
    xg = T(x3).requires_grad_(True)
    bg = T(bias).requires_grad_(True)
    mg = T(mask).requires_grad_(True)
    out = twa.lane_window_attention(xg, bg, mg, 4, NH, 0.1)
    out.backward(T(do))
    assert dict(_build.launch_counts) == before
    dx3, dbias = twa.lane_window_attention_backward_plain(T(x3), T(bias), T(mask), T(do), 4,
                                                          NH, 0.1)
    assert torch.equal(xg.grad, dx3) and torch.equal(bg.grad, dbias)
    assert mg.grad is None
    with pytest.raises(ValueError, match="x3 must be"):
        twa.lane_window_attention(T(x3[:, None]), T(bias), T(mask), 4, NH, 0.1)
    with pytest.raises(ValueError, match="multiple"):
        twa.lane_window_attention(T(x3[:6]), T(bias), T(mask), 4, NH, 0.1)
    with pytest.raises(ValueError, match="mask"):
        twa.lane_window_attention(T(x3), T(bias), T(mask[:2]), 4, NH, 0.1)


def test_window_partition_t_split_is_a_reshape():
    """The JAX t-sliced partition (``t_split=4``) is a reshape of the port's
    (4, 7, 7) partition, and ``_per_frame`` of it is the port's per-frame
    (1, 7, 7) partition, which ``window_reverse`` undoes."""
    from empirical_mvm_tpu.models import video_swin as jvs
    x = np.arange(2 * 4 * 14 * 14 * 3, dtype=np.float32).reshape(2, 4, 14, 14, 3)
    sliced = T(np.array(jvs.window_partition(jnp.asarray(x), (4, 7, 7), t_split=4)))
    assert sliced.shape == (8, 4, 49, 3)
    assert torch.equal(twa.window_partition(T(x), (4, 7, 7)).reshape(sliced.shape), sliced)
    frames = twa.window_partition(T(x), (1, 7, 7))
    assert torch.equal(_per_frame(sliced, 4), frames)
    assert torch.equal(twa.window_reverse(frames, (1, 7, 7), 2, 4, 14, 14), T(x))


def test_swin2d_config_is_the_jax_one():
    from empirical_mvm_tpu.models import encoders2d as jenc
    assert SWIN2D_SIZES == jenc.SWIN2D_SIZES
    base = swin2d_config("base")          # the teacher of the 2d_feature target
    assert (base.embed_dim, base.depths, base.num_heads, base.num_features) == (
        128, (2, 2, 18, 2), (4, 8, 16, 32), 1024)
    for size in SWIN2D_SIZES:
        want = jenc.swin2d_config(size)
        got = swin2d_config(size)
        for field in ("patch_size", "embed_dim", "depths", "num_heads", "window_size",
                      "final_norm", "drop_path_rate", "patch_norm"):
            assert getattr(got, field) == getattr(want, field), (size, field)


# the teacher: swin2d geometry at two stages of base widths
TEACHER = dict(patch_size=(1, 4, 4), embed_dim=128, depths=(2, 2), num_heads=(4, 8),
               window_size=(1, 7, 7), drop_path_rate=0.0, final_norm=False)


@pytest.mark.parametrize("frames", [4, 2, 3])
def test_teacher_swin_matches_jax(monkeypatch, frames):
    """JAX folds f = 4, 2 and 1 frames (T = 3 does not fold); the port runs
    the lane kernel on (1, 7, 7) windows with the full mask. Stage 0 (14 x 14, 4 windows) has a shifted block;
    stage 1 (7 x 7) clamps to one unshifted window."""
    monkeypatch.setenv("EMVM_PALLAS_INTERPRET", "1")
    jm = JSwin(config=jcfg.SwinConfig(use_pallas_attention=True, use_pallas_layernorm=True,
                                      **TEACHER))
    rs = np.random.RandomState(frames)
    x = rs.randn(1, frames, 56, 56, 3).astype(np.float32)
    params = drawn_params(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                                         jnp.asarray(x)))["params"], rs)
    ref = jax.jit(lambda p, a: jm.apply({"params": p}, a))(params, jnp.asarray(x))
    tm = SwinTransformer3D(tcfg.SwinConfig(**TEACHER), fused_norms=True)
    assert all(type(m) is FusedLayerNorm for m in tm.modules() if isinstance(m, LayerNorm))
    tm.load_state_dict(convert.swin3d_state_dict(params, TEACHER["depths"]))
    with torch.no_grad():
        out = tm(T(x))
    assert out.shape == (1, frames, 7, 7, 256)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-3)
