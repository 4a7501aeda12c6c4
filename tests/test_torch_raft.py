"""The port's RAFT teacher (``empirical_mvm_torch/teachers/raft.py``)
against the JAX ``teachers/raft.py``, fp32 on the CPU: the sampling
convention, the correlation pyramid and its lookup, the convex upsampling,
the whole ``RAFT`` (raft_large's widths) at 64^2 with 3 updates, and the
weights from JAX to the port through ``convert.raft_state_dict`` and back
through the JAX ``raft_params_from_torch``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import tests.conftest  # noqa: F401  (pins JAX to the CPU)
from tests.torch_threads import torch_threads  # noqa: F401  (the cores' share under xdist)

import jax
import jax.numpy as jnp

from empirical_mvm_tpu.teachers import raft as jraft
from empirical_mvm_torch.models import convert
from empirical_mvm_torch.teachers import raft as traft

T = torch.from_numpy
# fp32, summation order only
TOL = dict(atol=1e-5, rtol=1e-5)


def test_bilinear_sample_convention():
    """Integer coordinates are pixel centres; corners outside the image add
    0, each on its own; the same as ``grid_sample(align_corners=True,
    padding_mode="zeros")`` on the normalized coordinates, and as JAX."""
    rs = np.random.RandomState(0)
    img = rs.randn(2, 5, 7, 3).astype(np.float32)
    pts = np.concatenate([rs.uniform(-2, 8, (2, 40, 2)),
                          np.array([[[0, 0], [6, 4], [-1, 2], [3, -0.5], [6.5, 4], [7, 5]]] * 2)],
                         axis=1).astype(np.float32)
    got = traft.bilinear_sample(T(img), T(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(jraft.bilinear_sample(img, pts)), **TOL)
    fixed = got[:, 40:].numpy()
    np.testing.assert_allclose(fixed[:, 0], img[:, 0, 0], **TOL)       # (x, y) = (0, 0)
    np.testing.assert_allclose(fixed[:, 1], img[:, 4, 6], **TOL)       # the far corner
    assert not fixed[:, 2].any() and not fixed[:, 5].any()            # wholly outside
    np.testing.assert_allclose(fixed[:, 3], 0.5 * img[:, 0, 3], **TOL)  # half a row above
    np.testing.assert_allclose(fixed[:, 4], 0.5 * img[:, 4, 6], **TOL)  # half a column right
    grid = torch.stack([T(pts[..., 0]) / 6 * 2 - 1, T(pts[..., 1]) / 4 * 2 - 1], -1)
    ref = F.grid_sample(T(img).permute(0, 3, 1, 2), grid[:, None], align_corners=True,
                        padding_mode="zeros")[:, :, 0].transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


@pytest.fixture(scope="module")
def pyramid():
    """Feature maps of (2, 8, 8, 16): levels 8, 4, 2 and 1, the last 1 x 1."""
    rs = np.random.RandomState(1)
    f1, f2 = (rs.randn(2, 8, 8, 16).astype(np.float32) for _ in range(2))
    return f1, f2, traft.build_corr_pyramid(T(f1), T(f2)), jraft.build_corr_pyramid(f1, f2)


def test_build_corr_pyramid_matches_jax(pyramid):
    _, _, got, want = pyramid
    assert [tuple(v.shape) for v in got] == [(128, s, s, 1) for s in (8, 4, 2, 1)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_index_corr_pyramid_matches_jax(pyramid):
    """At centres inside, near and beyond every level's edge (the 1 x 1
    level included), radius 4 and 2; channel order (di, dj), di on x."""
    _, _, got, want = pyramid
    rs = np.random.RandomState(2)
    base = np.stack(np.meshgrid(np.arange(8.0), np.arange(8.0), indexing="xy"), -1)
    coords = (base[None] + rs.uniform(-6, 6, (2, 8, 8, 2))).astype(np.float32)
    for radius in (4, 2):
        out = traft.index_corr_pyramid(got, T(coords), radius)
        ref = jraft.index_corr_pyramid(want, jnp.asarray(coords), radius)
        assert out.shape == (2, 8, 8, 4 * (2 * radius + 1) ** 2)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # the lookup is bilinear_sample of each level on the offset grid
    side, lvl = 9, got[1][..., 0].reshape(2, 64, 4, 4)
    di, dj = np.meshgrid(np.arange(-4, 5.0), np.arange(-4, 5.0), indexing="ij")
    pts = coords.reshape(2, 64, 1, 2) / 2 + np.stack([di, dj], -1).reshape(1, 1, side * side, 2)
    want1 = traft.bilinear_sample(lvl.reshape(128, 4, 4, 1),
                                  T(pts.reshape(128, side * side, 2).astype(np.float32)))
    out = traft.index_corr_pyramid(got, T(coords), 4)
    np.testing.assert_allclose(out[..., 81:162].reshape(128, 81).numpy(),
                               want1[..., 0].numpy(), **TOL)


def test_convex_upsample_matches_jax():
    rs = np.random.RandomState(3)
    flow = rs.randn(2, 3, 4, 2).astype(np.float32)
    mask = rs.randn(2, 3, 4, 576).astype(np.float32)
    got = traft.convex_upsample(T(flow), T(mask))
    assert got.shape == (2, 24, 32, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(jraft.convex_upsample(flow, mask)),
                               atol=1e-5)


@pytest.fixture(scope="module")
def carried():
    """raft_large at 64^2 with 3 updates: JAX params (init plus N(0, 0.05),
    the batch-norm variances kept positive, the flow head's last kernel
    scaled by 0.1) and the port carrying them. Unscaled, the random deltas
    move the flow by about 30 pixels an update, far out of the 8 x 8
    correlation grid, where each update multiplies the two packages' fp32
    order differences by about 10 (2.2e-4 after one update, 2.6e-2 after
    three, of flows of 92); scaled, the flows reach about 10 pixels, as a
    real pair's do."""
    jm = jraft.RAFT(num_updates=3)
    rs = np.random.RandomState(4)
    i1, i2 = (rs.randn(2, 64, 64, 3).astype(np.float32) for _ in range(2))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(i1), jnp.asarray(i2))["params"]

    def noise(path, p):
        p = np.asarray(p) + 0.05 * rs.randn(*np.shape(p)).astype(np.float32)
        return np.abs(p) + 0.5 if path[-1].key == "var" else p

    params = jax.tree_util.tree_map_with_path(noise, params)
    params["flow_head"]["conv2"]["kernel"] = 0.1 * params["flow_head"]["conv2"]["kernel"]
    tm = traft.RAFT(num_updates=3)
    tm.load_state_dict(convert.raft_state_dict(params))
    return jm, params, tm, i1, i2


def test_raft_matches_jax(carried):
    """The final flow (B, 64, 64, 2) against the JAX model, fp32 through
    the encoders and 3 updates."""
    jm, params, tm, i1, i2 = carried
    want = np.asarray(jax.jit(lambda p, a, b: jm.apply({"params": p}, a, b))(
        params, jnp.asarray(i1), jnp.asarray(i2)))
    with torch.no_grad():
        got = tm(T(i1), T(i2))
    assert got.shape == (2, 64, 64, 2) and got.dtype == torch.float32
    assert np.abs(want).max() > 5.0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=1e-4)


def test_raft_state_dict_round_trip(carried):
    """The port's RAFT state_dict, with torchvision's names and the context
    encoder's batch-norm statistics as buffers, back through the JAX
    ``raft_params_from_torch``, leaf for leaf."""
    _, params, tm, _, _ = carried
    sd = convert.raft_state_dict(params)
    assert set(sd) == set(tm.state_dict())
    assert {"feature_encoder.layer2.0.downsample.0.weight",
            "context_encoder.layer3.1.convnormrelu2.1.running_var",
            "update_block.recurrent_block.convgru2.convq.bias",
            "mask_predictor.conv.weight"} <= set(sd)
    buffers = {n for n, _ in tm.named_buffers()}
    assert buffers and all(n.endswith(("running_mean", "running_var")) for n in buffers)
    back = jraft.raft_params_from_torch({k: v.numpy() for k, v in sd.items()})
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))
