"""The port's DPT depth teacher (``empirical_mvm_torch/teachers/dpt.py``)
against the JAX ``teachers/dpt.py`` at tiny widths, fp32 on the CPU.

The JAX model runs under ``EMVM_PALLAS_INTERPRET=1``, as the depth target
builds it: its LayerNorms take ``fused_layer_norm`` (row 1) and its
attention ``lane_self_attention`` (row 5) in interpret mode at width 128,
``packed_self_attention`` (row 11) at width 96, which is no multiple of
128; the port takes the same routes with its plain versions. The weights go
from JAX to the port through ``convert.dpt_state_dict`` and back through the
JAX ``dpt_params_from_torch``.
"""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (pins JAX to the CPU)
from tests.torch_threads import torch_threads  # noqa: F401  (the cores' share under xdist)

import jax
import jax.numpy as jnp

from empirical_mvm_tpu.ops import window_attention as jwa
from empirical_mvm_tpu.teachers import dpt as jdpt
from empirical_mvm_torch.models import convert
from empirical_mvm_torch.ops import window_attention as twa
from empirical_mvm_torch.teachers import dpt as tdpt

# vit_dim, vit_heads: width 128 takes row 5, 96 row 11; the other fields
# shrink the reassemble and fusion widths; the 6 x 6 position grid shrinks
# to the 4 x 4 of a 64^2 input
TINY = dict(vit_depth=4, hooks=(0, 1, 2, 3), reassemble_features=(16, 32, 48, 48),
            features=32, train_grid=6)
WIDTHS = {"row5": (128, 2), "row11": (96, 2)}
# fp32 through 4 blocks and the conv stack: summation order only; atol is
# a share of the largest output (about 20; 5.6e-5 apart at row 5)
TOL = dict(atol=1e-5, rtol=1e-4)


def _jax_dpt(route, monkeypatch, non_negative=True):
    monkeypatch.setenv("EMVM_PALLAS_INTERPRET", "1")
    dim, heads = WIDTHS[route]
    jm = jdpt.DPTDepth(vit_dim=dim, vit_heads=heads, non_negative=non_negative, **TINY)
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    rs = np.random.RandomState(1)
    params = jax.tree.map(lambda p: np.asarray(p) + 0.05 * rs.randn(*np.shape(p))
                          .astype(np.float32), params)
    tm = tdpt.DPTDepth(vit_dim=dim, vit_heads=heads, non_negative=non_negative, **TINY)
    tm.load_state_dict(convert.dpt_state_dict(params))
    return jm, params, tm, x


@pytest.mark.parametrize("route", sorted(WIDTHS))
def test_dpt_depth_matches_jax(route, monkeypatch):
    """The depth map against the JAX model (without the final ReLU, so that
    no output hides at 0); both packages route the attention alike."""
    dim, heads = WIDTHS[route]
    assert jwa.lane_sa_attention_fits(2, 17, dim, heads) == (route == "row5") \
        == twa.lane_sa_attention_fits(2, 17, dim, heads)
    jm, params, tm, x = _jax_dpt(route, monkeypatch, non_negative=False)
    want = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (2, 64, 64) and got.dtype == torch.float32
    assert (want > 0).mean() > 0.1 and (want < 0).mean() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=TOL["atol"] * np.abs(want).max(),
                               rtol=TOL["rtol"])
    with torch.no_grad():
        tm.non_negative = True
        np.testing.assert_array_equal(tm(torch.from_numpy(x)).numpy(),
                                      np.maximum(got.numpy(), 0.0))


def test_interp2x_matches_jax():
    x = np.random.RandomState(2).randn(2, 5, 3, 4).astype(np.float32)
    np.testing.assert_allclose(tdpt.interp2x(torch.from_numpy(x)).numpy(),
                               np.asarray(jdpt._interp2x(jnp.asarray(x))), atol=1e-6)


@pytest.mark.parametrize("grid,gh,gw", [(24, 14, 14), (6, 4, 4), (6, 9, 9), (6, 4, 9)])
def test_position_embedding_resize_matches_jax(grid, gh, gw):
    """Shrinking (24 -> 14 at 224^2: antialiased), growing and mixed grids
    against the JAX model's ``jax.image.resize`` (dpt.py:184-187), the class
    token's entry kept."""
    d = 8
    pos = np.random.RandomState(3).randn(1, 1 + grid * grid, d).astype(np.float32)
    pos_grid = jnp.asarray(pos[0, 1:]).reshape(1, grid, grid, d)
    want = jax.image.resize(pos_grid, (1, gh, gw, d), "bilinear").reshape(1, gh * gw, d)
    got = tdpt.resize_pos_embed(torch.from_numpy(pos), grid, gh, gw)
    assert got.shape == (1, 1 + gh * gw, d)
    np.testing.assert_array_equal(got[:, :1].numpy(), pos[:, :1])
    np.testing.assert_allclose(got[:, 1:].numpy(), np.asarray(want), atol=2e-6)


def test_dpt_state_dict_round_trip(monkeypatch):
    """The port's DPT state_dict, with MiDaS / timm names, back through the
    JAX ``dpt_params_from_torch``, leaf for leaf; refinenet4 holds no
    ``resConfUnit1`` on either side."""
    _, params, tm, _ = _jax_dpt("row5", monkeypatch)
    sd = convert.dpt_state_dict(params)
    assert set(sd) == set(tm.state_dict())
    assert {"pretrained.model.blocks.3.attn.qkv.weight", "pretrained.act_postprocess1.4.weight",
            "pretrained.act_postprocess4.4.bias", "scratch.refinenet1.resConfUnit1.conv1.weight",
            "scratch.output_conv.4.weight"} <= set(sd)
    assert not any(k.startswith("scratch.refinenet4.resConfUnit1") for k in sd)
    back = jdpt.dpt_params_from_torch({k: v.numpy() for k, v in sd.items()},
                                      vit_depth=TINY["vit_depth"])
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))
