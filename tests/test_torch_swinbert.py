"""The SwinBERT video layout (``swinbert``) and ``go_feat``'s frame-order and
video-token inputs (``odr``, ``vt_mask``) against the JAX package at tiny
widths, fp32 on the CPU, inputs from numpy with a seed.

``EncVideo(swinbert)``: ``fc`` to 512, ``img_embedding`` to the hidden
size, a zero "fake CLS" whose mask is 0 leading each frame's tokens; the
caption step on it (the fusion's seq2seq mask then has a hole at each
frame's first video key) and its greedy decoders; a ``*SwinBERT*.pt``
written from a random port model under SwinBERT's key names, read by the
port's ``load_torch_violet_ckpt`` (every parameter set, ``img_embedding``
included) and by the JAX package's (whose importer drops
``img_embedding``: ROADMAP Queue 3). ``odr`` and ``vt_mask`` on the
VIOLET-layout ``EncVideo`` and on each 2D encoder, which take them as JAX
does (``EncImgSwin`` reads ``vt_mask`` under concat fusion only, the R50
and MERLOT encoders neither).

The trunk is ``tests/test_torch_qa_heads.py``'s (a Video Swin at embed 32,
depths 1/1/1/1, a 2-layer BERT of hidden 32, 2 frames of 64^2, every
dropout 0). Weights are the port's, moved off their init and carried by
``models/convert.py``. Outputs within atol 2e-5 / rtol 1e-4 (the R50's
1e-4: fp32 through 53 convolutions), masks exactly, gradients within atol
2e-4 / rtol 1e-3.
"""

import dataclasses

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (pins JAX to the CPU)
from tests.torch_threads import torch_threads  # noqa: F401  (the cores' share under xdist)

import jax
import jax.numpy as jnp

from chip_smoke import swinbert_names
from empirical_mvm_tpu.core import config as jcfg
from empirical_mvm_tpu.models import captioning as jcap
from empirical_mvm_tpu.models import encoders2d as jenc
from empirical_mvm_tpu.models import violet as jviolet
from empirical_mvm_tpu.train import checkpoint as jckpt
from empirical_mvm_tpu.train import losses as jlosses
from empirical_mvm_torch.core import config as tcfg
from empirical_mvm_torch.models import captioning as tcap
from empirical_mvm_torch.models import convert
from empirical_mvm_torch.models import encoders2d as tenc
from empirical_mvm_torch.models import violet as tviolet
from empirical_mvm_torch.train import checkpoint as tckpt
from tests.test_torch_captioning import caption_batch
from tests.test_torch_encoders2d import _enc_tree, seeded_weights
from tests.test_torch_qa_heads import FWD_TOL, GRAD_TOL, MLM, clips, two_steps_match_jax
from tests.test_torch_qa_heads import model_cfg as qa_cfg
from tests.test_torch_text_stack import carried

SWINBERT = dict(swinbert=True)
B, T, MAX_LEN = 2, 2, 6
HW = 4                                    # 64^2 clips: 2 x 2 tokens a frame
R50_TOL = dict(atol=1e-4, rtol=1e-4)


def _moved(module, seed):
    """The module's parameters moved off their init by 0.05 N(0, 1)."""
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(torch.from_numpy((0.05 * rs.randn(*p.shape)).astype(np.float32)))
    return module


def _enc_video(seed, **switches):
    """A port ``EncVideo`` with moved weights, the JAX one and its tree."""
    tm = _moved(tviolet.EncVideo(qa_cfg(tcfg, **switches)), seed)
    return tm, jviolet.EncVideo(config=qa_cfg(jcfg, **switches)), _enc_tree(tm.state_dict())


def _inputs(seed):
    """uint8 clips, a frame order with frame 0 in place and the others
    swapped in row 0 and all in place in row 1, and a (B, T, 1) video-token
    mask with one frame off."""
    rs = np.random.RandomState(seed)
    odr = np.array([[0, 1], [0, 1]], np.int32)
    odr[0] = [1, 0]
    vt_mask = np.ones((B, T, 1), np.int32)
    vt_mask[1, 1] = 0
    return clips(rs), odr, vt_mask


def _enc_pass(tm, jm, tree, img, **kw):
    """Features, mask and every parameter's gradient of sum(feat * w) on
    both sides (JAX's carried to the port's names)."""
    t_kw = {k: torch.from_numpy(v) for k, v in kw.items()}
    f, m = tm(torch.from_numpy(img), **t_kw)
    w = np.random.RandomState(9).randn(*f.shape).astype(np.float32)
    tm.zero_grad(set_to_none=True)
    (f * torch.from_numpy(w)).sum().backward()

    def loss(p):
        jf, jmask = jm.apply({"params": p}, jnp.asarray(img),
                             **{k: jnp.asarray(v) for k, v in kw.items()})
        return jnp.sum(jf * w), (jf, jmask)

    (_, (jf, jmask)), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(tree)
    got = {n: p.grad for n, p in tm.named_parameters()}
    want = convert.enc_img_state_dict(jax.tree.map(np.asarray, jg), "")
    return f.detach().numpy(), m.numpy(), np.asarray(jf), np.asarray(jmask), got, want


def _grads_match(got, want, unused=()):
    assert set(got) == set(want)
    for name, g in got.items():
        if name in unused:
            assert g is None and not want[name].any(), name
            continue
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)


def test_enc_video_swinbert_layout_matches_jax():
    """Features, the mask (exactly), every gradient: ``fc`` and
    ``img_embedding`` and no embeddings or norm; each frame's first token
    exactly 0 with mask 0, the others 1 unless ``vt_mask`` takes the frame
    off; ``odr`` not read."""
    tm, jm, tree = _enc_video(0, **SWINBERT)
    assert set(tree) == {"swin", "fc", "img_embedding"}
    assert tm.fc.weight.shape == (512, 256) and tm.img_embedding.weight.shape == (32, 512)
    img, odr, vt_mask = _inputs(1)
    f, m, jf, jmask, got, want = _enc_pass(tm, jm, tree, img, odr=odr, vt_mask=vt_mask)
    np.testing.assert_allclose(f, jf, **FWD_TOL)
    np.testing.assert_array_equal(m, jmask)
    _grads_match(got, want)
    lv = 1 + HW
    assert f.shape == (B, T * lv, 32) and m.dtype == np.int32
    assert (f[:, ::lv] == 0).all() and (m[:, ::lv] == 0).all()
    np.testing.assert_array_equal(m.reshape(B, T, lv)[:, :, 1:],
                                  np.broadcast_to(vt_mask, (B, T, HW)))
    with torch.no_grad():
        f2, _ = tm(torch.from_numpy(img))
    np.testing.assert_array_equal(f2.numpy(), f)


def test_enc_video_odr_and_vt_mask_match_jax():
    """The VIOLET layout: a frame at its own slot gets ``emb_len``, a moved
    one ``emb_odr`` (which then has a gradient), and ``vt_mask`` multiplies
    the mask; against JAX, and against the pass without them."""
    tm, jm, tree = _enc_video(2)
    img, odr, vt_mask = _inputs(3)
    f, m, jf, jmask, got, want = _enc_pass(tm, jm, tree, img, odr=odr, vt_mask=vt_mask)
    np.testing.assert_allclose(f, jf, **FWD_TOL)
    np.testing.assert_array_equal(m, jmask)
    _grads_match(got, want)
    assert got["emb_odr"].abs().max() > 0
    np.testing.assert_array_equal(m.reshape(B, T, 1 + HW), np.broadcast_to(vt_mask,
                                                                            (B, T, 1 + HW)))
    with torch.no_grad():
        plain, ones = tm(torch.from_numpy(img))
    assert (ones == 1).all()
    lv = 1 + HW
    moved = np.abs(plain.numpy() - f).reshape(B, T, lv, -1).max(axis=(2, 3))
    assert (moved[0] > 1e-3).all() and (moved[1] == 0).all()   # row 1: every frame in place


ENCODERS_2D = {
    # name: (encoder, fusion, reads vt_mask)
    "swin_concat": ("swin", "concat", True),
    "swin_mean": ("swin", "mean", False),
    "r50": ("r50", "concat", False),
    "merlot": ("merlot", "concat", False),
}
SWIN2D = dict(patch_size=(1, 4, 4), embed_dim=32, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8),
              window_size=(1, 7, 7), drop_path_rate=0.0, final_norm=False)


def _encoder_2d(name):
    kind, fusion, _ = ENCODERS_2D[name]
    if kind == "swin":
        cfg = {c: dataclasses.replace(qa_cfg(c, vis_backbone="swin2d", temporal_fusion=fusion),
                                      swin_custom=c.SwinConfig(**SWIN2D)) for c in (tcfg, jcfg)}
        tm = _moved(tenc.EncImgSwin(cfg[tcfg], fusion), 4)
        jm = jenc.EncImgSwin(cfg[jcfg], fusion=fusion)
    elif kind == "r50":
        tm = seeded_weights(tenc.EncImgR50(qa_cfg(tcfg), fusion), 5)
        jm = jenc.EncImgR50(qa_cfg(jcfg), fusion=fusion)
    else:
        tm = seeded_weights(tenc.EncImgMerlot(qa_cfg(tcfg), vit_depth=1), 6)
        jm = jenc.EncImgMerlot(qa_cfg(jcfg), vit_depth=1)
    return tm, jm, _enc_tree(tm.state_dict())


@pytest.mark.parametrize("name", list(ENCODERS_2D))
def test_2d_encoders_take_odr_and_vt_mask_as_jax(name):
    """Each 2D encoder's features and mask with ``odr`` and a
    (B, T * (1 + h w)) ``vt_mask`` against JAX's: ``odr`` is read by none,
    ``vt_mask`` by ``EncImgSwin`` under concat fusion only."""
    tm, jm, tree = _encoder_2d(name)
    img, odr, _ = _inputs(7)
    img = img.astype(np.float32) / 255.0
    vt_mask = np.ones((B, T * (1 + HW)), np.int32)
    vt_mask[0, 3:7] = 0
    with torch.no_grad():
        f, m = tm(torch.from_numpy(img), odr=torch.from_numpy(odr),
                  vt_mask=torch.from_numpy(vt_mask))
        plain, ones = tm(torch.from_numpy(img))
    jf, jmask = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(
        tree, jnp.asarray(img), jnp.asarray(odr), jnp.asarray(vt_mask))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf),
                               **(FWD_TOL if name.startswith("swin") else R50_TOL))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(f.numpy(), plain.numpy())
    reads = ENCODERS_2D[name][2]
    np.testing.assert_array_equal(m.numpy(), vt_mask if reads else ones.numpy())
    assert (ones == 1).all()


def test_go_feat_passes_odr_vt_mask_and_the_text_mask():
    """``go_feat`` hands ``odr`` and ``vt_mask`` (keywords) to the image
    encoder and the text mask to the text encoder; ``generator`` stays the
    fourth positional argument."""
    cfg = qa_cfg(tcfg)
    tm = tviolet.VioletBase(cfg)
    img, odr, vt_mask = (torch.from_numpy(a) for a in _inputs(8))
    txt = torch.randint(104, 200, (B, 8), generator=torch.Generator().manual_seed(0))
    mask = torch.ones(B, 8, dtype=torch.int32)
    with torch.no_grad():
        fi, mi, ft, mt = tm.go_feat(img, txt, mask, None, odr=odr, vt_mask=vt_mask)
        want_fi, want_mi = tm.enc_img(img, odr=odr, vt_mask=vt_mask)
    assert torch.equal(fi, want_fi) and torch.equal(mi, want_mi) and mt is mask
    assert torch.equal(ft, tm.enc_txt(txt))


@pytest.fixture(scope="module")
def swinbert_caption():
    """The tiny captioning model in the SwinBERT layout on both sides."""
    tm = tcap.VioletCaptioning(qa_cfg(tcfg, **SWINBERT), device="cpu", seed=2)
    jm = jcap.VioletCaptioning(config=qa_cfg(jcfg, **SWINBERT))
    return tm, jm, carried(tm, MLM)


def test_swinbert_caption_step_and_decoders_match_jax(swinbert_caption):
    """Two ``caption`` steps against the JAX agent's (the fusion's seq2seq
    mask with a hole at each frame's first video key), then the greedy
    tokens of the re-encoding decoder (JAX ``generate(use_cache=False)``)
    and of the K/V-cached one (JAX's default ``generate``), identical."""
    tm, jm, params = swinbert_caption
    out = {}
    no_grad = two_steps_match_jax(
        jm, params, tm, caption_batch(1), "caption",
        lambda o, b: jlosses.label_smoothed_nll(o, b["mask_ans"]), MLM, out=out)
    assert not no_grad
    jparams = out["jax_params"]
    img = caption_batch(2)["img"]
    for use_cache in (False, True):
        want = np.asarray(jax.jit(lambda p, im: jm.apply(
            {"params": p}, im, MAX_LEN, use_cache=use_cache, method=jm.generate))(
                jparams, jnp.asarray(img)))
        got = (tm.generate_cached if use_cache else tm.generate)(torch.from_numpy(img), MAX_LEN)
        np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want[:, 1:])) > 1


def test_swinbert_pt_loads_every_parameter_and_jax_drops_img_embedding(tmp_path, caplog):
    """A ``*SwinBERT*.pt`` written from a random port model in SwinBERT's
    names loads through ``load_torch_violet_ckpt`` into a fresh
    ``swinbert`` model with every parameter equal to the file's,
    ``img_embedding`` included, and ``report_key_diff`` reports no missing
    key. The JAX package's reader of the same file (``violet_params_from_torch``
    under it) leaves ``enc_img.img_embedding`` out of its tree, so a JAX
    model keeps its init there (ROADMAP Queue 3)."""
    src = tcap.VioletCaptioning(qa_cfg(tcfg, **SWINBERT), device="cpu", seed=3)
    sd = {k: v + 0.05 for k, v in src.state_dict().items()}
    path = str(tmp_path / "swinbert_vatex_SwinBERT.pt")
    torch.save(swinbert_names(sd), path)
    fresh = tcap.VioletCaptioning(qa_cfg(tcfg, **SWINBERT), device="cpu", seed=4)
    expected = fresh.state_dict()
    with caplog.at_level("WARNING"):
        loaded = tckpt.load_torch_violet_ckpt(path, fresh.config, expected=expected)
    assert "Missing checkpoint keys" not in caplog.text
    assert set(loaded) == set(expected)
    fresh.load_state_dict(loaded)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k]), k
    missing, unexpected = convert.report_key_diff(set(expected), set(loaded))
    assert not missing and not unexpected
    jtree = jckpt.load_torch_violet_ckpt(path, qa_cfg(jcfg, **SWINBERT), heads=MLM)
    assert set(jtree["enc_img"]) == {"swin", "fc"}               # no img_embedding
    want = convert.flax_from_state_dict(sd, fresh.config, MLM)
    assert "img_embedding" in want["enc_img"]
    np.testing.assert_array_equal(jtree["enc_img"]["fc"]["kernel"],
                                  want["enc_img"]["fc"]["kernel"])
    # what a JAX run overlays on its init leaves img_embedding there: the
    # file's weights, which every JAX forward then misses
    assert np.abs(sd["enc_img.img_embedding.weight"].numpy()).max() > 0.05


@pytest.mark.parametrize("raw", [
    {"txt_backbone_embed_only": False},
    {"swinbert": True},
    {"swinbert": True, "vis_backbone": "swin2d", "temporal_fusion": "concat"},
    {"swin_custom": {"drop_rate": 0.1, "attn_drop_rate": 0.1}},
])
def test_run_configs_of_the_variants_load_as_in_jax(raw):
    """Each variant's keys load in both packages' ``load_run_config`` to the
    same values, and the port builds the trunk they name; as in JAX,
    ``swinbert`` is read by the Video Swin's ``EncVideo`` alone."""
    t, j = tcfg.load_run_config(raw), jcfg.load_run_config(raw)
    for key in ("txt_backbone_embed_only", "swinbert", "vis_backbone"):
        assert getattr(t.model, key) == getattr(j.model, key), key
    for key in ("drop_rate", "attn_drop_rate"):
        assert getattr(t.model.swin, key) == getattr(j.model.swin, key), key
    with torch.device("meta"):
        trunk = tviolet.VioletBase(t.model)
    assert (trunk.enc_txt.txt_trsfr is None) == t.model.txt_backbone_embed_only
    assert hasattr(trunk.enc_img, "img_embedding") == (
        t.model.swinbert and t.model.vis_backbone == "vidswin")
