"""The port's dVAE teacher (``empirical_mvm_torch/teachers/dvae.py``)
against the JAX ``teachers/dvae.py`` at tiny widths, fp32 on the CPU: the
encoder's logits, the tokens of ``extract_vq_tokens``, and the weights from
JAX to the port through ``convert.dvae_state_dict`` and back through the JAX
``dvae_params_from_torch``.
"""

import numpy as np
import torch

import tests.conftest  # noqa: F401  (pins JAX to the CPU)
from tests.torch_threads import torch_threads  # noqa: F401  (the cores' share under xdist)

import jax
import jax.numpy as jnp

from empirical_mvm_tpu.teachers import dvae as jdvae
from empirical_mvm_torch.models import convert
from empirical_mvm_torch.teachers import dvae as tdvae

# n_hid 16, one block a group (so every block but group 1's has an id_path),
# 64 tokens; a 64^2 input gives 8 x 8 cells. Weights N(0, 0.2) around the
# init, so that the logits, not the output bias, pick the tokens
TINY = dict(n_hid=16, n_blk_per_group=1, vocab_size=64)


def _carried():
    jm = jdvae.DvaeEncoder(**TINY)
    img = np.random.RandomState(0).randn(3, 64, 64, 3).astype(np.float32)
    pix = np.asarray(jdvae.map_pixels(jnp.clip(jdvae.unnormalize_imagenet(img), 0, 1)))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(pix))["params"]
    rs = np.random.RandomState(1)
    params = jax.tree.map(lambda p: np.asarray(p) + 0.2 * rs.randn(*np.shape(p))
                          .astype(np.float32), params)
    tm = tdvae.DvaeEncoder(**TINY)
    tm.load_state_dict(convert.dvae_state_dict(params))
    return jm, params, tm, img, pix


def test_dvae_encoder_and_tokens_match_jax():
    """Logits within fp32 summation order of the JAX encoder's; the tokens
    of ``extract_vq_tokens`` equal to the JAX ``DvaeTeacher``'s, and to the
    argmax of the port's own logits (the chunked argmax)."""
    jm, params, tm, img, pix = _carried()
    want = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, jnp.asarray(pix)))
    with torch.no_grad():
        got = tm(torch.from_numpy(pix))
        tokens = tm.extract_vq_tokens(torch.from_numpy(img))
    assert got.shape == (3, 8, 8, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=1e-5)
    teacher = jdvae.DvaeTeacher(params, dtype=jnp.float32, **TINY)
    want_tokens = np.asarray(teacher.extract_vq_tokens(jnp.asarray(img)))
    assert tokens.shape == (3, 8, 8) and len(np.unique(want_tokens)) > 8
    np.testing.assert_array_equal(tokens.numpy(), want_tokens)
    np.testing.assert_array_equal(tokens.numpy(), got.argmax(-1).numpy())


def test_dvae_pixel_maps_match_jax():
    x = np.random.RandomState(2).randn(4, 5, 3).astype(np.float32)
    np.testing.assert_allclose(tdvae.unnormalize_imagenet(torch.from_numpy(x)).numpy(),
                               np.asarray(jdvae.unnormalize_imagenet(x)), atol=1e-7)
    np.testing.assert_allclose(tdvae.map_pixels(torch.from_numpy(x)).numpy(),
                               np.asarray(jdvae.map_pixels(jnp.asarray(x))), atol=1e-7)
    assert tdvae.LOGIT_LAPLACE_EPS == jdvae.LOGIT_LAPLACE_EPS
    np.testing.assert_array_equal(np.float32(tdvae.IMAGENET_MEAN), jdvae.IMAGENET_MEAN)
    np.testing.assert_array_equal(np.float32(tdvae.IMAGENET_STD), jdvae.IMAGENET_STD)


def test_dvae_state_dict_round_trip():
    """The port's dVAE state_dict, with the DALL-E encoder's names, back
    through the JAX ``dvae_params_from_torch``, leaf for leaf."""
    _, params, tm, _, _ = _carried()
    sd = convert.dvae_state_dict(params)
    assert set(sd) == set(tm.state_dict())
    assert {"blocks.input.w", "blocks.group_2.block_1.id_path.b",
            "blocks.group_4.block_1.res_path.conv_4.w", "blocks.output.conv.b"} <= set(sd)
    assert "blocks.group_1.block_1.id_path.w" not in sd
    back = jdvae.dvae_params_from_torch({k: v.numpy() for k, v in sd.items()},
                                        n_blk_per_group=TINY["n_blk_per_group"])
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))
