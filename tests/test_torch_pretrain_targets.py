"""The port's hog, 3d_feature and 2d_clip pretrain targets against the JAX
package at tiny widths: ``VioletPretrain(mvm_target=("hog", "3d_feature",
"2d_clip"))`` with its frozen Video Swin and CLIP teachers, carrying the JAX
params through ``state_dict_from_flax``, with the same masks and VTM
negatives on both sides and every dropout and drop-path rate at 0; fp32 on
the CPU. Each side computes its own HOG target of the clip.

The 3D teacher is shrunk on both sides by replacing ``SwinConfig.base``
(read when the model is built) in the JAX package's ``core/config.py`` and
in the port's copy, inside the fixture only; the JAX ``feat_target_size`` is
its ``num_features`` (the port sizes ``fc_mvm`` from the teacher) and both
take the same tiny ``clip_arch``. The JAX masks, negatives and ScoreHead
dropout are replaced as in ``test_torch_pretrain.py``. Also here: the
targets ("3d_feature", "2d_feature"), where, as in the JAX package's ``if
3d ... elif 2d``, one 3D teacher serves both losses.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (pins JAX to the CPU)
from tests.torch_threads import torch_threads  # noqa: F401  (the cores' share under xdist)

import jax
import jax.numpy as jnp

from empirical_mvm_tpu.core import config as jcfg
from empirical_mvm_tpu.data import masking as jmask
from empirical_mvm_tpu.models import pretrain as jpretrain
from empirical_mvm_tpu.models import violet as jviolet
from empirical_mvm_tpu.models.torch_import import (swin3d_params_from_torch,
                                                   violet_params_from_torch)
from empirical_mvm_tpu.teachers.clip import clip_params_from_torch
from empirical_mvm_tpu.train import optimizer as jopt
from empirical_mvm_tpu.train import train_step as jts
from empirical_mvm_torch.core import config as tcfg
from empirical_mvm_torch.data import masking as tmask
from empirical_mvm_torch.models import convert
from empirical_mvm_torch.models.pretrain import VioletPretrain, draw_negatives
from empirical_mvm_torch.train import optimizer as topt
from empirical_mvm_torch.train.train_step import create_train_state, make_pretrain_train_step
from tests.test_torch_pretrain import (B, GRAD_TOL, LOSS_TOL, _batch, _max, _model_cfg,
                                       _np_tree, _t)

# the shrunk Video Swin teacher (4 stages: 64 / 32 = 2 = the student's grid;
# a shifted block in the two stages wider than the 7 x 7 window) and CLIP
# (hidden, layers, heads, mlp; 2 x 2 patches of 32 at 64^2)
TEACHER3D = dict(embed_dim=16, depths=(2, 2, 1, 1), num_heads=(1, 2, 4, 8))
FEAT = TEACHER3D["embed_dim"] * 8
CLIP = (48, 2, 4, 96)
TARGETS = ("hog", "3d_feature", "2d_clip")
HEADS = {"fc": "score_head", "fc_mtm": "mlm_head", "fc_mvm": "score_head",
         "fc_mvm_clip": "score_head", "decoder_hog": "linear"}
LABELS = topt.GROUPS + (topt.FROZEN,)


def _frozen(name):
    return name.startswith(("feature_model.", "clip_model."))


@pytest.fixture(scope="module")
def patched():
    """The batch and the port's draws, with the JAX package's draws, its
    ScoreHead dropout and its ``SwinConfig.base`` (and the port's) replaced
    for the whole module."""
    batch = _batch()
    gen = torch.Generator().manual_seed(3)
    txt_t = torch.from_numpy(batch["txt"])
    draws = tmask.draw_masks(gen, txt_t, 2, 2, 2, special_token_ids=(101, 102, 0),
                             mask_token_id=103, p_mask=0.3, mask_types=("bm", "rm"))
    neg_idx = draw_negatives(gen, B, 3)
    mb = tmask.apply_masking(draws, torch.zeros(B, 2, 64, 64, 3), txt_t, mask_token_id=103)
    pix, cov = mb.mvm_mask.numpy(), mb.cov.numpy()
    new_txt, ans = mb.txt.numpy(), mb.ans_mtm.numpy()

    def fake_apply_masking(key, img, txt, vq, **kw):
        return jmask.MaskedBatch(img=img * (1.0 - jnp.asarray(pix)), txt=jnp.asarray(new_txt),
                                 ans_mtm=jnp.asarray(ans),
                                 ans_mvm=jnp.full((B, 2 * 5), -1, jnp.int32),
                                 mvm_mask=jnp.asarray(pix), cov=jnp.asarray(cov))

    with pytest.MonkeyPatch.context() as mp:
        for pkg in (jcfg, tcfg):
            mp.setattr(pkg.SwinConfig, "base", classmethod(lambda cls: cls(**TEACHER3D)))
        mp.setattr(jmask, "apply_masking", fake_apply_masking)
        mp.setattr(jax.lax, "top_k",
                   lambda x, k: (None, jnp.asarray(neg_idx.numpy(), jnp.int32)))
        mp.setattr(jpretrain, "ScoreHead", functools.partial(jviolet.ScoreHead, dropout=0.0))
        yield dict(batch=batch, draws=draws, neg_idx=neg_idx,
                   args=[jnp.asarray(batch[k]) for k in ("img", "txt", "mask")])


def _carried(patched, targets):
    """JAX model and params for ``targets``, and the port model carrying
    them (score-head dropout off)."""
    jm = jpretrain.VioletPretrain(config=_model_cfg(jcfg), mvm_target=targets,
                                  pretrain_masks=("bm", "rm"), feat_target_size=FEAT,
                                  clip_arch=CLIP)
    key = jax.random.PRNGKey(0)
    params = jax.jit(lambda: jm.init({"params": key, "dropout": key, "mask": key},
                                     *patched["args"], method=jm.losses)["params"])()
    rs = np.random.RandomState(2)
    params = jax.tree.map(lambda p: np.asarray(p) + 0.05 * rs.randn(*np.shape(p))
                          .astype(np.float32), params)
    tm = VioletPretrain(_model_cfg(tcfg), mvm_target=targets, clip_arch=CLIP, device="cpu",
                        seed=1)
    heads = {k: v for k, v in HEADS.items() if k in params}
    tm.load_state_dict(convert.state_dict_from_flax(params, tm.config, heads))
    for head in ("fc", "fc_mvm", "fc_mvm_clip"):
        if hasattr(tm, head):
            getattr(tm, head)[0].p = 0.0
    return dict(jm=jm, params=params, tm=tm, heads=heads)


@pytest.fixture(scope="module")
def slice_(patched):
    return _carried(patched, TARGETS)


def _losses_and_grads(patched, carried):
    """Losses and parameter gradients of both sides (dropout off): JAX's as
    port-named tensors; the port's None kept."""
    jm, params, tm = carried["jm"], carried["params"], carried["tm"]

    def jloss(p):
        ls = jm.apply({"params": p}, *patched["args"], method=jm.losses, deterministic=True,
                      rngs={"mask": jax.random.PRNGKey(1)})
        return ls["total"], ls

    jgrads, jls = jax.jit(jax.grad(jloss, has_aux=True))(params)
    b = _t(patched["batch"])
    tm.zero_grad(set_to_none=True)
    ls = tm.losses(b["img"], b["txt"], b["mask"], draws=patched["draws"],
                   neg_idx=patched["neg_idx"])
    ls["total"].backward()
    got = {n: None if p.grad is None else p.grad.clone() for n, p in tm.named_parameters()}
    tm.zero_grad(set_to_none=True)
    return ls, jls, got, convert.state_dict_from_flax(_np_tree(jgrads), tm.config,
                                                      carried["heads"])


@pytest.fixture(scope="module")
def grads(patched, slice_):
    return _losses_and_grads(patched, slice_)


def _hold_losses_and_grads(ls, jls, got, want, names):
    assert set(ls) == {"mtm", "vtm", *names, "total"} == set(jls)
    for k in ls:
        np.testing.assert_allclose(ls[k].item(), float(jls[k]), err_msg=k, **LOSS_TOL)
    assert set(got) == set(want)
    # no gradient: the teachers (no_grad; stop_gradient gives zeros in JAX)
    # and the frame-order embedding, which the pretrain forward does not use
    teachers = {n for n in got if _frozen(n)}
    no_grad = teachers | {"enc_img.emb_odr"}
    assert {n for n, g in got.items() if g is None} == no_grad
    for name in no_grad:
        assert not want[name].any(), name
    for name, g in got.items():
        if g is not None:
            np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)
    return teachers


def test_weight_carry_round_trip_of_the_three_target_tree(slice_):
    """Student and heads back through ``violet_params_from_torch``, the 3D
    teacher (final norm included) through ``swin3d_params_from_torch``,
    CLIP through ``clip_params_from_torch``, leaf for leaf."""
    params, tm = slice_["params"], slice_["tm"]
    sd = convert.state_dict_from_flax(params, tm.config, HEADS)
    assert set(sd) == set(tm.state_dict())
    assert "feature_model.norm.weight" in sd and "clip_model.pre_layrnorm.weight" in sd
    np_sd = {k: v.numpy() for k, v in sd.items()}
    back = violet_params_from_torch(np_sd, slice_["jm"].config, heads=HEADS)
    back["feature_model"] = swin3d_params_from_torch(np_sd, TEACHER3D["depths"],
                                                     prefix="feature_model.")
    back["clip_model"] = clip_params_from_torch(
        {k[len("clip_model."):]: v for k, v in np_sd.items() if k.startswith("clip_model.")},
        num_layers=CLIP[1])
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


def test_losses_and_gradients_match_jax(grads):
    teachers = _hold_losses_and_grads(*grads, ("mvm_hog", "mvm_3d_feature", "mvm_2d_clip"))
    assert {n.split(".")[0] for n in teachers} == {"feature_model", "clip_model"}


def test_3d_and_2d_feature_share_the_3d_teacher(patched):
    """("3d_feature", "2d_feature"): one ``feature_model``, the Video Swin
    (3D patch kernel, final norm), which both losses read, as the JAX ``if
    3d ... elif 2d`` builds it; the carried weights fit it and the losses
    are JAX's."""
    carried = _carried(patched, ("3d_feature", "2d_feature"))
    jm, params, tm = carried["jm"], carried["params"], carried["tm"]
    assert tm.feature_model.patch_embed.proj.weight.shape[2] == 2 and tm.feature_model.norm
    jls = jax.jit(lambda p: jm.apply({"params": p}, *patched["args"], method=jm.losses,
                                     deterministic=True,
                                     rngs={"mask": jax.random.PRNGKey(1)}))(params)
    b = _t(patched["batch"])
    with torch.no_grad():
        ls = tm.losses(b["img"], b["txt"], b["mask"], draws=patched["draws"],
                       neg_idx=patched["neg_idx"])
    assert set(ls) == {"mtm", "vtm", "mvm_3d_feature", "mvm_2d_feature", "total"} == set(jls)
    for k in ls:
        np.testing.assert_allclose(ls[k].item(), float(jls[k]), err_msg=k, **LOSS_TOL)
    assert ls["mvm_3d_feature"].item() == ls["mvm_2d_feature"].item()


def test_optimizer_labels_both_teachers_frozen(slice_):
    """Every parameter's label is the one the JAX ``build_optimizer`` gives
    the leaf mapped onto it: ``frozen`` for both teachers, which get no Adam
    moments."""
    tm = slice_["tm"]

    def jlabel(path):
        keys = tuple(k.key for k in path)
        if jopt._is_frozen(".".join(keys), ()):
            return topt.FROZEN
        return jopt.default_group_fn(keys)

    codes = jax.tree_util.tree_map_with_path(
        lambda path, x: np.full(np.shape(x), LABELS.index(jlabel(path)), np.float32),
        slice_["params"])
    want = convert.state_dict_from_flax(codes, tm.config, HEADS)
    labels = topt.group_labels(tm)
    for name, code in want.items():
        assert (code == LABELS.index(labels[name])).all(), name
    assert {labels[n] for n in labels if _frozen(n)} == {topt.FROZEN}
    state = topt.AdamW(tm, 1e-3, 10).init(dict(tm.named_parameters()))
    assert not any(_frozen(n) for n in state["mu"])


def test_two_train_steps_match_make_pretrain_train_step(patched, slice_, grads):
    """Two steps of both train steps, held as ``assert_two_steps_match`` in
    test_torch_pretrain.py holds them for the swin2d and packed slices:
    resolved elements at 2e-6 but for at most 1e-4 of them (fp32 roundoff
    through two Adam updates), every element within Adam's 2 lr + 2e-6;
    both teachers bit-unchanged on both sides."""
    jm, params = slice_["jm"], slice_["params"]
    tm = copy.deepcopy(slice_["tm"])
    teacher_before = {n: p.detach().clone() for n, p in tm.named_parameters() if _frozen(n)}
    _, _, got_g, want_g = grads
    tx = jopt.build_optimizer(params, lr=1e-3, max_iter=10)
    jstep = jts.make_pretrain_train_step(jm, tx, mesh=None, donate=False)
    jstate = jts.create_train_state(params, tx)
    jbatch = {k: jnp.asarray(v) for k, v in patched["batch"].items()}
    opt = topt.AdamW(tm, 1e-3, 10)
    state = create_train_state(tm, opt)
    step = make_pretrain_train_step(tm, opt)
    batch = dict(_t(patched["batch"]), draws=patched["draws"], neg_idx=patched["neg_idx"])
    for _ in range(2):
        jstate, jls = jstep(jstate, jbatch, jax.random.PRNGKey(7))
        state, ls = step(state, batch, 7)
        np.testing.assert_allclose(ls["total"].item(), float(jls["total"]), **LOSS_TOL)
        assert all(np.isfinite(ls[k].item()) for k in ("mvm_hog", "mvm_3d_feature",
                                                        "mvm_2d_clip"))
    assert state.step == 2
    for teacher in ("feature_model", "clip_model"):
        jax.tree.map(np.testing.assert_array_equal, _np_tree(jstate.params[teacher]),
                     _np_tree(params[teacher]))
    want = convert.state_dict_from_flax(_np_tree(jstate.params), tm.config, HEADS)
    resolved_n, over = 0, []
    for name, p in tm.named_parameters():
        if _frozen(name):
            assert torch.equal(p.detach(), teacher_before[name]), name
            continue
        g = want_g[name].abs()
        got = got_g[name] if got_g[name] is not None else torch.zeros_like(want_g[name])
        resolved = (g > 100 * (got - want_g[name]).abs()) & (g > 1e-6)
        resolved_n += int(resolved.sum())
        d = (p.detach() - want[name]).abs()
        if _max(d[resolved]) > 2e-6:
            over.append((name, int((d[resolved] > 2e-6).sum()), _max(d[resolved])))
        assert _max(d) <= 2e-3 + 2e-6, (name, _max(d))
    assert sum(n for _, n, _ in over) <= 1e-4 * resolved_n, over
    trained = [n for n, _ in tm.named_parameters() if not _frozen(n)]
    assert resolved_n > 0.99 * sum(want_g[n].numel() for n in trained) - sum(
        int((want_g[n] == 0).sum()) for n in trained)


def test_a_given_hog_target_replaces_the_clips(slice_, patched):
    """``losses(hog=...)``, as the step passes ``batch["hog"]``: the hog
    loss reads the given target, the other losses are unchanged."""
    tm, b = slice_["tm"], _t(patched["batch"])
    kw = dict(draws=patched["draws"], neg_idx=patched["neg_idx"])
    with torch.no_grad():
        own = tm.losses(b["img"], b["txt"], b["mask"], **kw)
        zero = tm.losses(b["img"], b["txt"], b["mask"], hog=torch.zeros(B, 2, 64, 64), **kw)
    assert zero["mvm_hog"].item() != own["mvm_hog"].item()
    for k in ("mtm", "vtm", "mvm_3d_feature", "mvm_2d_clip"):
        assert zero[k].item() == own[k].item(), k
