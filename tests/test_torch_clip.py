"""The port's CLIP teacher (``empirical_mvm_torch/teachers/clip.py``)
against the JAX ``teachers/clip.py`` at tiny widths, fp32 on the CPU.

The JAX tower runs with ``use_pallas=True`` under
``EMVM_PALLAS_INTERPRET=1``, as the 2d_clip target builds it: its
attention takes the JAX route, ``lane_self_attention`` (row 5) in interpret
mode at width 128, ``packed_self_attention`` (row 11) at width 48, which is
no multiple of 128; the port takes the same route with its plain versions.
The weights go from JAX to the port through ``convert.clip_state_dict`` and
back through the JAX ``clip_params_from_torch``.
"""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (pins JAX to the CPU)
from tests.torch_threads import torch_threads  # noqa: F401  (the cores' share under xdist)

import jax
import jax.numpy as jnp

from empirical_mvm_tpu.ops import window_attention as jwa
from empirical_mvm_tpu.teachers import clip as jclip
from empirical_mvm_torch.models import convert
from empirical_mvm_torch.ops import window_attention as twa
from empirical_mvm_torch.teachers import clip as tclip

# (hidden, layers, heads, mlp) at 64^2: 2 x 2 patches of 32, L = 5
ARCHS = {"row11": (48, 2, 4, 96), "row5": (128, 2, 2, 256)}
# fp32 through 2 layers: summation order only
TOL = dict(atol=2e-5, rtol=2e-5)


def _jax_tower(arch, monkeypatch):
    monkeypatch.setenv("EMVM_PALLAS_INTERPRET", "1")
    d, layers, heads, mlp = arch
    jm = jclip.CLIPVisual(hidden_size=d, num_layers=layers, num_heads=heads, mlp_dim=mlp,
                          use_pallas=True)
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    rs = np.random.RandomState(1)
    params = jax.tree.map(lambda p: np.asarray(p) + 0.05 * rs.randn(*np.shape(p))
                          .astype(np.float32), params)
    return jm, params, x


@pytest.mark.parametrize("route", sorted(ARCHS))
def test_clip_visual_matches_jax(route, monkeypatch):
    """Last hidden state, pooled output and the feature grid against the
    JAX tower; both packages route the attention alike."""
    arch = ARCHS[route]
    d, layers, heads, _ = arch
    assert jwa.lane_sa_attention_fits(2, 5, d, heads) == (route == "row5") \
        == twa.lane_sa_attention_fits(2, 5, d, heads)
    jm, params, x = _jax_tower(arch, monkeypatch)
    tok, pooled = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, jnp.asarray(x))
    feats = jax.jit(lambda p, x: jm.apply({"params": p}, x, method=jm.features))(
        params, jnp.asarray(x))
    tm = tclip.CLIPVisual(*arch, image_size=64)
    tm.load_state_dict(convert.clip_state_dict(params))
    with torch.no_grad():
        got_tok, got_pooled = tm(torch.from_numpy(x))
        got_feats = tm.features(torch.from_numpy(x))
    assert got_feats.shape == (2, 2, 2, d)
    for got, want in ((got_tok, tok), (got_pooled, pooled), (got_feats, feats)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_clip_state_dict_round_trip(monkeypatch):
    """The port's CLIP state_dict, with HF names, back through the JAX
    ``clip_params_from_torch``, leaf for leaf; the names are HF's
    ``CLIPVisionModel`` ones, ``pre_layrnorm`` spelled as HF spells it."""
    arch = ARCHS["row11"]
    _, params, _ = _jax_tower(arch, monkeypatch)
    sd = convert.clip_state_dict(params)
    tm = tclip.CLIPVisual(*arch, image_size=64)
    assert set(sd) == set(tm.state_dict())
    assert {"pre_layrnorm.weight", "embeddings.patch_embedding.weight",
            "encoder.layers.1.self_attn.q_proj.weight", "post_layernorm.bias"} <= set(sd)
    back = jclip.clip_params_from_torch(
        {f"vision_model.{k}": v.numpy() for k, v in sd.items()}, num_layers=arch[1])
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


def test_renormalize_and_quick_gelu_match_jax():
    x = np.random.RandomState(3).randn(4, 8, 8, 3).astype(np.float32)
    np.testing.assert_allclose(
        tclip.renormalize_imagenet_to_clip(torch.from_numpy(x)).numpy(),
        np.asarray(jclip.renormalize_imagenet_to_clip(jnp.asarray(x))), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tclip.quick_gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jclip.quick_gelu(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)
    assert (tclip.CLIP_MEAN, tclip.CLIP_STD) == (jclip.CLIP_MEAN, jclip.CLIP_STD)
