"""Port ops against the JAX package: each kernel module's plain version (the
path a CPU tensor takes) against the JAX function, with the Pallas kernels
run in interpret mode; plus the wrappers' contract. The CUDA kernels against
their plain versions are in test_torch_cuda.py.

Inputs come from numpy with a seed; both sides run in fp32.
"""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (pins JAX to the CPU)
from tests.torch_threads import torch_threads  # noqa: F401  (the cores' share under xdist)

import jax.numpy as jnp

from empirical_mvm_tpu.ops import layernorm as jln
from empirical_mvm_tpu.ops import patch_embed as jpe
from empirical_mvm_tpu.ops import preprocess as jpp
from empirical_mvm_tpu.ops import window_attention as jwa
from empirical_mvm_torch.ops import _build
from empirical_mvm_torch.ops import layernorm as tln
from empirical_mvm_torch.ops import patch_embed as tpe
from empirical_mvm_torch.ops import preprocess as tpp
from empirical_mvm_torch.ops import window_attention as twa

T = torch.from_numpy


def _direct_inputs(seed=0):
    """The JAX direct-kernel test's shape (test_window_attention_kernel.py:524)."""
    rs = np.random.RandomState(seed)
    b, d, hp, wp, c, nh = 2, 2, 6, 9, 128, 4
    win = (2, 3, 3)
    n = 2 * 3 * 3
    nw = (hp // 3) * (wp // 3)
    x3 = (rs.randn(b, d, hp, wp, 3 * c) * 0.3).astype(np.float32)
    bias = (rs.randn(nh, n, n) * 0.1).astype(np.float32)
    mask = np.zeros((nw, n, n), np.float32)
    mask[1::2, : n // 2, n // 2:] = -100.0
    return x3, bias, mask, win, nh, (c // nh) ** -0.5


@pytest.mark.parametrize("has_mask", [True, False])
def test_direct_window_attention_matches_jax_kernel(has_mask):
    x3, bias, mask, win, nh, scale = _direct_inputs()
    n = bias.shape[-1]
    jmask = mask if has_mask else np.zeros((1, n, n), np.float32)
    ref = jwa.direct_window_attention(jnp.asarray(x3), jnp.asarray(bias),
                                      jnp.asarray(jmask), win, nh, scale,
                                      True, has_mask)
    out = twa.direct_window_attention(T(x3), T(bias), T(mask) if has_mask else None,
                                      win, nh, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


def test_window_attention_reference_matches_jax():
    rs = np.random.RandomState(1)
    b_, nh, n, hd, nw = 8, 4, 18, 32, 4
    q, k, v = (rs.randn(b_, nh, n, hd).astype(np.float32) for _ in range(3))
    bias = (rs.randn(nh, n, n) * 0.1).astype(np.float32)
    mask = np.where(rs.rand(nw, n, n) < 0.2, -100.0, 0.0).astype(np.float32)
    ref = jwa.window_attention_reference(*(jnp.asarray(a) for a in (q, k, v, bias, mask)),
                                         nw, hd ** -0.5)
    out = twa.window_attention_reference(T(q), T(k), T(v), T(bias), T(mask), nw,
                                         hd ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


def test_direct_plain_matches_partitioned_reference():
    """The plain direct version equals partition -> reference -> reverse."""
    x3, bias, mask, win, nh, scale = _direct_inputs(2)
    b, d, hp, wp, c3 = x3.shape
    c, n = c3 // 3, bias.shape[-1]
    xw = twa.window_partition(T(x3), win)
    qkv = xw.reshape(xw.shape[0], n, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
    ref = twa.window_attention_reference(qkv[0], qkv[1], qkv[2], T(bias), T(mask),
                                         mask.shape[0], scale)
    ref = twa.window_reverse(ref.transpose(1, 2).reshape(-1, n, c), win, b, d, hp, wp)
    out = twa.direct_window_attention(T(x3), T(bias), T(mask), win, nh, scale)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5, rtol=1e-4)


def _lane_inputs(seed=0):
    rs = np.random.RandomState(seed)
    b, l, c, nh = 4, 24, 128, 4
    x3 = (rs.randn(b, l, 3 * c) * 0.3).astype(np.float32)
    keep = np.ones((b, l), np.float32)
    keep[1, 17:] = 0
    keep[3, 5:] = 0
    bias1d = (1.0 - keep) * np.finfo(np.float32).min        # padded 1D mask
    mask = np.broadcast_to(bias1d[:, None, :], (b, l, l)).copy()
    return x3, mask, nh, (c // nh) ** -0.5


def test_lane_self_attention_matches_jax_kernel():
    x3, mask, nh, scale = _lane_inputs()
    ref = jwa.lane_self_attention(jnp.asarray(x3), jnp.asarray(mask),
                                  jnp.zeros((1,), jnp.int32), nh, scale, 0.0, True)
    out = twa.lane_self_attention(T(x3), T(mask), nh, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)
    # the broadcast (B, 1, L) view the BERT layers pass gives the same result
    view = T(np.ascontiguousarray(mask[:, :1])).expand(*mask.shape)
    out_view = twa.lane_self_attention(T(x3), view, nh, scale)
    np.testing.assert_array_equal(out_view.numpy(), out.numpy())


@pytest.mark.parametrize("eps", [1e-12, 1e-5])
def test_fused_layer_norm_matches_jax_kernel(eps):
    rs = np.random.RandomState(3)
    x = (rs.randn(5, 8, 768) * 2.0 + 0.5).astype(np.float32)
    g = (1.0 + 0.1 * rs.randn(768)).astype(np.float32)
    bt = (0.1 * rs.randn(768)).astype(np.float32)
    ref = jln.fused_layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(bt), eps, True)
    out = tln.fused_layer_norm(T(x), T(g), T(bt), eps)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_patch_embed_and_normalize_match_jax():
    rs = np.random.RandomState(4)
    img = rs.randint(0, 256, (2, 3, 18, 22, 3)).astype(np.uint8)   # ragged H, W
    w = (rs.randn(16, 3, 2, 4, 4) * 0.1).astype(np.float32)        # OIDHW
    b = rs.randn(16).astype(np.float32)
    x_j = jpp.normalize_uint8(jnp.asarray(img))
    x_t = tpp.maybe_normalize(T(img))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=1e-6, rtol=0)
    ref = jpe.patch_embed_3d(x_j, jnp.asarray(w.transpose(2, 3, 4, 1, 0)),
                             jnp.asarray(b))
    out = tpe.patch_embed_3d(x_t, T(w), T(b))
    assert out.shape == (2, 3, 5, 6, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    x3, bias, mask, win, nh, scale = _direct_inputs()
    lx3, lmask, lnh, lscale = _lane_inputs()
    before = dict(_build.launch_counts)
    twa.direct_window_attention(T(x3), T(bias), T(mask), win, nh, scale)
    twa.lane_self_attention(T(lx3), T(lmask), lnh, lscale)
    tln.fused_layer_norm(torch.ones(4, 8), torch.ones(8), torch.zeros(8))
    assert dict(_build.launch_counts) == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    x3, bias, mask, win, nh, scale = _direct_inputs()
    with pytest.raises(ValueError, match="D == wd"):      # two temporal windows
        twa.direct_window_attention(T(x3), T(bias), T(mask), (1, 3, 3), nh, scale)
    with pytest.raises(ValueError, match="padded"):
        twa.direct_window_attention(T(x3[:, :, :5]), T(bias), T(mask), win, nh, scale)
    lx3, lmask, lnh, lscale = _lane_inputs()
    with pytest.raises(ValueError, match="generator"):     # dropout draws its seed
        twa.lane_self_attention(T(lx3), T(lmask), lnh, lscale, p_drop=0.1)
    with pytest.raises(ValueError):
        tln.fused_layer_norm(torch.ones(4, 8), torch.ones(7), torch.zeros(8))


def test_kernel_library_name_follows_the_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert path == _build.library_path()
    assert {p.name for p in _build._sources()} >= {
        "layer_norm.cu", "window_attention.cu", "self_attention.cu",
        "lane_window_attention.cu"}
