"""The port's trained 2D Swin backbone (``vis_backbone="swin2d"``) against
the JAX package on the CPU; inputs from numpy with a seed, fp32.

* ``EncImgSwin``, concat and mean fusion, against the JAX ``EncImgSwin``
  that ``VioletBase(vis_backbone="swin2d")`` builds, run with
  ``EMVM_PALLAS_INTERPRET=1`` so that JAX takes its t-sliced lane window
  kernel forward and backward (embed 128, hd = 32: every stage's C is a
  multiple of 128, as the lane kernel needs): the outputs and every
  parameter gradient. The port runs the lane window kernel's plain
  versions, forward and backward, on each frame's windows.
* A tiny ``VioletPretrain`` with the swin2d concat backbone (pixel target):
  the weight carry of its tree, the losses, every gradient, two steps of
  ``make_pretrain_train_step``, and the optimizer labels, with the masks and
  negatives injected and every dropout and drop-path rate at 0 as in
  ``test_torch_pretrain.py``; and the same step at the 2D Swin-tiny's
  widths (C = 96 in stage 0, the packed route's plain version in stages
  0-1). JAX runs its XLA attention here (no interpret flag).
"""

import dataclasses

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (pins JAX to the CPU)
from tests.torch_threads import torch_threads  # noqa: F401  (the cores' share under xdist)

import jax
import jax.numpy as jnp

from empirical_mvm_tpu.core import config as jcfg
from empirical_mvm_tpu.models import encoders2d as jenc
from empirical_mvm_tpu.train import optimizer as jopt
from empirical_mvm_torch.core import config as tcfg
from empirical_mvm_torch.models import convert
from empirical_mvm_torch.models import encoders2d as tenc
from empirical_mvm_torch.models import video_swin
from empirical_mvm_torch.models.encoders2d import EncImgSwin, swin2d_config
from empirical_mvm_torch.models.pretrain import VioletPretrain
from empirical_mvm_torch.models.violet import VioletBase
from empirical_mvm_torch.ops.layernorm import FusedLayerNorm, LayerNorm
from empirical_mvm_torch.train import optimizer as topt
from tests.test_torch_pretrain import (BERT, GRAD_TOL, LOSS_TOL, _np_tree,
                                       assert_two_steps_match, carried_slice, drawn_params,
                                       losses_and_grads)
from tests.test_torch_pretrain_2d import synthetic_hf_swin

T = torch.from_numpy
# 2D geometry at base widths, cut to one block in the two narrowest stages
ENC_SWIN = dict(patch_size=(1, 4, 4), embed_dim=128, depths=(2, 2, 1, 1),
                num_heads=(4, 8, 16, 32), window_size=(1, 7, 7), drop_path_rate=0.0,
                final_norm=False)
ENC_BERT = dict(BERT, hidden_size=128, num_attention_heads=4, intermediate_size=256)
# the tiny student of the pretrain tests: shifted blocks in stages 0 and 1
SWIN2D = dict(patch_size=(1, 4, 4), embed_dim=16, depths=(2, 2, 1, 1), num_heads=(1, 2, 4, 8),
              window_size=(1, 7, 7), drop_path_rate=0.0, final_norm=False)
HEADS = {"fc": "score_head", "fc_mtm": "mlm_head", "decoder_pixel": "linear"}


def _enc_cfg(c, fusion):
    return c.ModelConfig(size_img=64, size_frame=4, vis_backbone="swin2d",
                         temporal_fusion=fusion, fusion=c.BertConfig(**ENC_BERT),
                         text=c.BertConfig(**ENC_BERT), swin_custom=c.SwinConfig(**ENC_SWIN))


@pytest.mark.parametrize("fusion,frames", [("concat", 4), ("mean", 2)])
def test_enc_img_swin_matches_jax(monkeypatch, fusion, frames):
    """64 x 64 frames: stage 0 (16 x 16, padded to 3 x 3 windows) and stage 1
    (8 x 8, 2 x 2) have shifted blocks; stages 2 and 3 clamp to one
    unshifted window. JAX folds the 4 or 2 frames into one t-sliced window."""
    monkeypatch.setenv("EMVM_PALLAS_INTERPRET", "1")
    jm = jenc.EncImgSwin(config=_enc_cfg(jcfg, fusion), fusion=fusion)
    rs = np.random.RandomState(frames)
    x = rs.randn(2, frames, 64, 64, 3).astype(np.float32)
    params = drawn_params(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                                         jnp.asarray(x)))["params"], rs)
    t = frames if fusion == "concat" else 1
    w = rs.randn(2, t * 5, 128).astype(np.float32)

    def jloss(p):
        feat, mask = jm.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(feat * w), (feat, mask)

    jgrads, (ref, jmask_) = jax.jit(jax.grad(jloss, has_aux=True))(params)
    tm = EncImgSwin(_enc_cfg(tcfg, fusion), fusion)
    assert isinstance(tm.embeds.norm, FusedLayerNorm)
    assert all(type(m) is LayerNorm for m in tm.swin.modules() if isinstance(m, LayerNorm))
    assert (tm.embeds.emb_odr is not None) == (fusion == "concat")
    tm.load_state_dict(convert.enc_img_state_dict(params, prefix=""))
    feat, mask = tm(T(x))
    assert feat.shape == (2, t * 5, 128) and torch.equal(mask, T(np.array(jmask_)))
    np.testing.assert_allclose(feat.detach().numpy(), np.asarray(ref), atol=2e-4, rtol=1e-3)
    (feat * T(w)).sum().backward()
    want = convert.enc_img_state_dict(_np_tree(jgrads), prefix="")
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        if p.grad is None:                  # the frame-order embedding: unused
            assert name == "embeds.emb_odr" and not want[name].any()
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name,
                                   **GRAD_TOL)


def _model_cfg(c):
    return c.ModelConfig(size_img=64, size_frame=2, size_txt=8, vis_backbone="swin2d",
                         temporal_fusion="concat", fusion=c.BertConfig(**BERT),
                         text=c.BertConfig(**BERT), swin_custom=c.SwinConfig(**SWIN2D))


@pytest.fixture(scope="module")
def slice_():
    """JAX model and params, the port model carrying them, the batch and
    the fixed draws, with the JAX package's draws replaced by them (as in
    test_torch_pretrain.py)."""
    yield from carried_slice(_model_cfg)


def test_weight_carry_of_the_swin2d_tree(slice_):
    """Every leaf of the JAX tree lands in exactly one entry of the port's
    state_dict, element for element (leaves filled with distinct codes),
    the EncImgSwin leaves where their names say; a HF ``SwinModel``
    checkpoint loads into the backbone under ``enc_img.swin.``."""
    params, tm = slice_["params"], slice_["tm"]
    leaves, treedef = jax.tree.flatten(params)
    sizes = np.cumsum([0] + [np.size(x) for x in leaves])
    codes = jax.tree.unflatten(treedef, [np.arange(a, b, dtype=np.float32).reshape(np.shape(x))
                                         for a, b, x in zip(sizes[:-1], sizes[1:], leaves)])
    assert sizes[-1] < 2 ** 24                            # exact in fp32
    sd = convert.state_dict_from_flax(codes, tm.config, HEADS)
    assert set(sd) == set(tm.state_dict())
    got = np.sort(np.concatenate([v.numpy().ravel() for v in sd.values()]))
    np.testing.assert_array_equal(got, np.arange(sizes[-1], dtype=np.float32))
    img = params["enc_img"]
    sd = convert.state_dict_from_flax(params, tm.config, HEADS)
    np.testing.assert_array_equal(sd["enc_img.swin2bert.weight"].numpy(),
                                  np.asarray(img["swin2bert"]["kernel"]).T)
    np.testing.assert_array_equal(sd["enc_img.embeds.norm.weight"].numpy(),
                                  np.asarray(img["embeds"]["norm"]["scale"]))
    for k in ("emb_cls", "emb_pos", "emb_len", "emb_odr"):
        np.testing.assert_array_equal(sd[f"enc_img.embeds.{k}"].numpy(),
                                      np.asarray(img["embeds"][k]))
    depths, heads = SWIN2D["depths"], SWIN2D["num_heads"]
    hf = synthetic_hf_swin(depths, heads, SWIN2D["embed_dim"])
    hf_sd = convert.swin2d_state_dict_from_hf(hf, depths, "enc_img.swin.")
    m = VioletPretrain(_model_cfg(tcfg), device="cpu")
    assert set(hf_sd) == {k for k in m.state_dict() if k.startswith("enc_img.swin.")}
    m.load_state_dict({**m.state_dict(), **hf_sd})


@pytest.fixture(scope="module")
def grads(slice_):
    """Losses and parameter gradients of both sides at the carried params
    (dropout off): JAX's as port-named tensors, the port's None as zeros."""
    return losses_and_grads(slice_)


def test_swin2d_losses_and_gradients_match_jax(grads):
    ls, jls, got, want, no_grad = grads
    assert set(ls) == {"mtm", "vtm", "mvm_pixel", "total"} == set(jls)
    for k in ls:
        np.testing.assert_allclose(ls[k].item(), float(jls[k]), err_msg=k, **LOSS_TOL)
    assert set(got) == set(want)
    # the lane window backward reaches the swin: every swin parameter has a
    # gradient; only the unused frame-order embedding has none
    assert no_grad == {"enc_img.embeds.emb_odr"}
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)


def test_swin2d_two_train_steps_match_make_pretrain_train_step(slice_, grads):
    """As ``test_two_train_steps_match_make_pretrain_train_step`` of
    test_torch_pretrain.py, on the swin2d backbone. Its wide last stages
    (64 and 128 channels) hold about 250,000 resolved elements, and a few
    whose step-1 gradient nearly cancels move by up to +-lr on either side
    whatever their step-0 gradient (5 read, 2e-5 at most): at most 1e-4 of
    the resolved elements may exceed 2e-6."""
    assert_two_steps_match(slice_, grads, HEADS, outliers=1e-4)


# the 2D Swin-tiny at its real widths (C = 96, 192, 384, 768; heads 3, 6,
# 12, 24), cut to depths (2, 2, 1, 1): shifted blocks in stages 0 and 1,
# which the C % 128 rule sends to the packed route, stages 2 and 3 on the
# lane window route
TINY2D = dict(SWIN2D, embed_dim=96, num_heads=(3, 6, 12, 24))


def _tiny2d_cfg(c):
    return dataclasses.replace(_model_cfg(c), swin_custom=c.SwinConfig(**TINY2D))


@pytest.fixture(scope="module")
def tiny2d_slice():
    yield from carried_slice(_tiny2d_cfg,
                             drawn=lambda shapes: drawn_params(shapes, np.random.RandomState(2)))


def test_swin2d_tiny_widths_step_matches_jax_on_the_packed_route(tiny2d_slice, monkeypatch):
    """The pretrain step's losses and every gradient on the swin2d backbone
    at Swin-tiny widths (the configuration of ``chip_smoke.py`` phase 45,
    depth-cut): stages 0-1 call ``packed_window_attention`` (its plain
    version here), stages 2-3 ``lane_window_attention``; against JAX (XLA
    attention), held as the swin2d slice above. The update after them is
    the swin2d slice's (``test_swin2d_two_train_steps_match_...``)."""
    calls = {"packed_window_attention": 0, "lane_window_attention": 0}
    for name in calls:
        fn = getattr(video_swin, name)

        def counted(*a, fn=fn, name=name, **k):
            calls[name] += 1
            return fn(*a, **k)

        monkeypatch.setattr(video_swin, name, counted)
    grads = losses_and_grads(tiny2d_slice)
    assert calls == {"packed_window_attention": 4, "lane_window_attention": 2}
    ls, jls, got, want, no_grad = grads
    for k in ls:
        np.testing.assert_allclose(ls[k].item(), float(jls[k]), err_msg=k, **LOSS_TOL)
    assert no_grad == {"enc_img.embeds.emb_odr"} and set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)


def test_swin2d_optimizer_labels_match_jax(slice_):
    """The port's group of every parameter is the JAX ``default_group_fn``
    label of the leaf mapped onto it: ``swin2bert`` lands in the swin group
    (its name holds "swin"), the embeddings' norm weight and every bias in
    nodecay."""
    tm = slice_["tm"]
    codes = jax.tree_util.tree_map_with_path(
        lambda path, x: np.full(np.shape(x), topt.GROUPS.index(
            jopt.default_group_fn(tuple(k.key for k in path))), np.float32),
        slice_["params"])
    want = convert.state_dict_from_flax(codes, tm.config, HEADS)
    labels = topt.group_labels(tm)
    for name, code in want.items():
        assert (code == topt.GROUPS.index(labels[name])).all(), name
    assert labels["enc_img.swin2bert.weight"] == "swin_decay"
    assert labels["enc_img.swin2bert.bias"] == "swin_nodecay"
    assert labels["enc_img.embeds.norm.weight"] == "other_nodecay"
    assert labels["enc_img.embeds.emb_pos"] == "other_decay"


def test_swin2d_config_builds_the_slice():
    """configs/pretrain.json with the backbone replaced by the trained 2D
    Swin (concat fusion): its VioletBase holds an EncImgSwin on
    ``swin2d_config("base")`` geometry (checked at tiny widths), plain swin
    LayerNorms and stochastic depth 0.2; mean fusion builds without MVM and
    refuses it; ResNet-50 and MERLOT build their encoders (MERLOT with
    concat fusion only)."""
    run = tcfg.load_run_config("configs/pretrain.json")
    model = dataclasses.replace(run.model, vis_backbone="swin2d", temporal_fusion="concat")
    base = swin2d_config(model.vis_backbone_size)
    assert (base.patch_size, base.window_size, base.depths, base.num_heads,
            base.drop_path_rate, base.num_features) == (
        (1, 4, 4), (1, 7, 7), (2, 2, 18, 2), (4, 8, 16, 32), 0.2, 1024)
    tiny = dataclasses.replace(_model_cfg(tcfg), swin_custom=None, vis_backbone_size="tiny",
                               size_img=run.model.size_img)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tenc.SWIN2D_SIZES, "tiny", (16, (1, 1, 1, 1), (1, 2, 4, 8)))
        m = VioletPretrain(tiny, device="cpu")
        assert isinstance(m.enc_img, EncImgSwin) and m.enc_img.swin2bert.in_features == 128
        assert m.enc_img.swin.layers[0].blocks[0].drop_path_rate == 0.0
        assert m.enc_img.swin.layers[3].blocks[0].drop_path_rate == pytest.approx(0.2)
        mean = dataclasses.replace(tiny, temporal_fusion="mean")
        assert m.enc_img.embeds.emb_odr is not None
        assert VioletBase(mean).enc_img.embeds.emb_odr is None
        with pytest.raises(ValueError, match="mean temporal fusion"):
            VioletPretrain(mean, device="cpu")
        VioletPretrain(mean, pretrain_tasks=("mtm", "vtm"), device="cpu")
    r50 = VioletBase(dataclasses.replace(tiny, vis_backbone="r50"))
    assert isinstance(r50.enc_img, tenc.EncImgR50) and r50.enc_img.fusion == "concat"
    merlot = VioletBase(dataclasses.replace(tiny, vis_backbone="merlot"))
    assert isinstance(merlot.enc_img, tenc.EncImgMerlot) and len(merlot.enc_img.vit) == 12
    with pytest.raises(ValueError, match="concat"):
        VioletBase(dataclasses.replace(tiny, vis_backbone="merlot", temporal_fusion="mean"))
