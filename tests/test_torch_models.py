"""Port models against the JAX package at tiny widths, weights carried from
the JAX params by ``state_dict_from_flax``; fp32 on the CPU, inputs from
numpy with a seed. Tolerance atol 2e-4, rtol 1e-3 (fp32 summation order
through several layers)."""

import dataclasses

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (pins JAX to the CPU)

import jax
import jax.numpy as jnp

from empirical_mvm_tpu.core import config as jcfg
from empirical_mvm_tpu.models.bert import BertEncoder as JBertEncoder
from empirical_mvm_tpu.models.bert import extended_attention_mask as j_ext_mask
from empirical_mvm_tpu.models.tasks import VioletRetrieval as JVioletRetrieval
from empirical_mvm_tpu.models.torch_import import violet_params_from_torch
from empirical_mvm_tpu.models.video_swin import SwinTransformer3D as JSwin
from empirical_mvm_torch.core import config as tcfg
from empirical_mvm_torch.models import convert
from empirical_mvm_torch.models.bert import BertEncoder, extended_attention_mask
from empirical_mvm_torch.models.tasks import VioletRetrieval
from empirical_mvm_torch.models.video_swin import SwinTransformer3D

TOL = dict(atol=2e-4, rtol=1e-3)
BERT = dict(vocab_size=200, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64)
SWIN = dict(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8),
            drop_path_rate=0.0)


def _model_cfg(c):
    """The same tiny ModelConfig built from package ``c``'s dataclasses."""
    return c.ModelConfig(size_img=64, size_frame=2, size_txt=8,
                         fusion=c.BertConfig(**BERT), text=c.BertConfig(**BERT),
                         swin_custom=c.SwinConfig(**SWIN))


def _perturb(params, seed):
    """Add noise to every leaf so zero-initialised biases and unit LayerNorm
    scales are exercised too."""
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda p: np.asarray(p) + 0.05 * rs.randn(*np.shape(p))
                        .astype(np.float32), params)


def _np(t):
    return t.detach().numpy()


@pytest.fixture(scope="module")
def retrieval():
    """JAX VioletRetrieval params and the port model carrying them."""
    jmodel = JVioletRetrieval(config=_model_cfg(jcfg))
    rs = np.random.RandomState(0)
    img = rs.randint(0, 256, (2, 2, 64, 64, 3)).astype(np.uint8)
    txt = rs.randint(5, 200, (2, 8)).astype(np.int32)
    mask = np.ones((2, 8), np.int32)
    mask[1, 5:] = 0
    params = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(img),
                                         jnp.asarray(txt), jnp.asarray(mask))["params"])()
    params = _perturb(params, 1)
    tmodel = VioletRetrieval(_model_cfg(tcfg), device="cpu")
    tmodel.load_state_dict(convert.state_dict_from_flax(
        params, tmodel.config, heads={"fc": "score_head"}))
    return jmodel, params, tmodel, (img, txt, mask)


def _japply(jmodel, params, *args, method=None):
    return jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a, method=method))(
        params, *args)


def test_weight_carry_reproduces_the_jax_tree(retrieval):
    """state_dict_from_flax followed by the JAX package's own importer gives
    back the JAX param tree leaf for leaf: the port's names are the reference
    checkpoint's names."""
    jmodel, params, tmodel, _ = retrieval
    sd = convert.state_dict_from_flax(params, tmodel.config, heads={"fc": "score_head"})
    back = violet_params_from_torch({k: v.numpy() for k, v in sd.items()},
                                    jmodel.config, heads={"fc": "score_head"})
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert np.shape(got[path]) == np.shape(leaf), jax.tree_util.keystr(path)
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))
    # and the port module takes exactly these keys
    assert set(sd) == set(tmodel.state_dict())


def test_swin_stage_matches_jax_direct_kernel(monkeypatch):
    """One swin stage (an unshifted and a shifted block) against JAX running
    its direct Pallas kernel in interpret mode
    (the pattern of test_window_attention_kernel.py:573)."""
    monkeypatch.setenv("EMVM_PALLAS_INTERPRET", "1")
    kw = dict(patch_size=(1, 4, 4), embed_dim=128, depths=(2,), num_heads=(4,),
              window_size=(8, 7, 7), drop_path_rate=0.0, final_norm=False)
    jm = JSwin(config=jcfg.SwinConfig(use_pallas_attention=True, **kw))
    x = np.random.RandomState(0).rand(1, 4, 56, 56, 3).astype(np.float32)
    params = _perturb(jax.jit(lambda: jm.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x))["params"])(), 2)
    ref = jax.jit(lambda p, a: jm.apply({"params": p}, a))(params, jnp.asarray(x))
    tm = SwinTransformer3D(tcfg.SwinConfig(**kw))
    tm.load_state_dict(convert.swin3d_state_dict(params, kw["depths"]))
    with torch.inference_mode():
        out = tm(torch.from_numpy(x))
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)


def test_bert_encoder_matches_jax():
    cfg = dict(BERT, hidden_size=64)
    jm = JBertEncoder(jcfg.BertConfig(**cfg))
    rs = np.random.RandomState(3)
    x = rs.randn(3, 10, 64).astype(np.float32)
    keep = np.ones((3, 10), np.int32)
    keep[0, 6:] = 0
    keep[2, 3:] = 0
    jb = j_ext_mask(jnp.asarray(keep))
    params = _perturb(jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                              jb)["params"])(), 4)
    ref, _ = jax.jit(lambda p: jm.apply({"params": p}, jnp.asarray(x), jb))(params)
    tm = BertEncoder(tcfg.BertConfig(**cfg))
    tm.load_state_dict(convert.bert_encoder_state_dict(params, 2))
    with torch.inference_mode():
        out = tm(torch.from_numpy(x), extended_attention_mask(torch.from_numpy(keep)))
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)


def test_encoders_match_jax(retrieval):
    """EncVideo on uint8 clips and the text embeddings."""
    jmodel, params, tmodel, (img, txt, mask) = retrieval
    fi, mi = _japply(jmodel, params, jnp.asarray(img),
                     method=lambda m, a: m.enc_img(a))
    ft = _japply(jmodel, params, jnp.asarray(txt), method=lambda m, a: m.enc_txt(a))
    with torch.inference_mode():
        tfi, tmi = tmodel.enc_img(torch.from_numpy(img))
        tft = tmodel.enc_txt(torch.from_numpy(txt))
    np.testing.assert_allclose(_np(tfi), np.asarray(fi), **TOL)
    np.testing.assert_array_equal(_np(tmi), np.asarray(mi))
    np.testing.assert_allclose(_np(tft), np.asarray(ft), **TOL)


def test_retrieval_all_pairs_matches_jax(retrieval):
    jmodel, params, tmodel, (img, txt, mask) = retrieval
    ref = _japply(jmodel, params, *(jnp.asarray(a) for a in (img, txt, mask)))
    with torch.inference_mode():
        out = tmodel(*(torch.from_numpy(a) for a in (img, txt, mask)))
    assert out.shape == (2, 2)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)


def test_encode_and_score_pairs_match_jax(retrieval):
    """Multi-clip encode (mean over clips, mask of the first clip) and stage-2
    scoring of (text, video) rows."""
    jmodel, params, tmodel, (_, txt, mask) = retrieval
    img6 = np.random.RandomState(5).randint(0, 256, (2, 3, 2, 64, 64, 3)).astype(np.uint8)
    args = tuple(jnp.asarray(a) for a in (img6, txt, mask))
    ref = _japply(jmodel, params, *args, method=jmodel.encode)
    with torch.inference_mode():
        out = tmodel.encode(*(torch.from_numpy(a) for a in (img6, txt, mask)))
        pairs = [torch.from_numpy(np.array(a))[[0, 1, 1, 0]] for a in ref]
        tscore = tmodel.score_pairs(*pairs)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(_np(o), np.asarray(r), **TOL)
    jscore = _japply(jmodel, params, *(jnp.asarray(np.asarray(a)[[0, 1, 1, 0]]) for a in ref),
                     method=jmodel.score_pairs)
    assert tscore.shape == (4,)
    np.testing.assert_allclose(_np(tscore), np.asarray(jscore), **TOL)


def test_model_keeps_fp32_params_and_computes_in_its_dtype():
    cfg = dataclasses.replace(_model_cfg(tcfg), size_img=32)
    m = VioletRetrieval(cfg, dtype=torch.bfloat16, device="cpu", seed=3)
    assert all(p.dtype == torch.float32 for p in m.parameters())
    assert not any(k.endswith("relative_position_index") for k in m.state_dict())
    img = torch.randint(0, 256, (1, 2, 32, 32, 3), dtype=torch.uint8)
    with torch.inference_mode():
        fi, mi, ft, mt = m.encode(img, torch.ones(1, 8, dtype=torch.int32),
                                  torch.ones(1, 8, dtype=torch.int32))
    assert fi.dtype == ft.dtype == torch.bfloat16
    assert torch.isfinite(fi.float()).all()
    # the same seed gives the same weights
    m2 = VioletRetrieval(cfg, dtype=torch.bfloat16, device="cpu", seed=3)
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(), m2.parameters()))
