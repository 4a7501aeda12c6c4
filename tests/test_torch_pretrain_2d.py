"""The port's 2d_feature pretrain slice against the JAX package at tiny
widths: ``VioletPretrain(mvm_target=("2d_feature",))`` with its frozen 2D
Swin teacher, carrying the JAX params through ``state_dict_from_flax``, with
the same masks and VTM negatives on both sides and every dropout and
drop-path rate at 0; fp32 on the CPU.

The teacher is shrunk on both sides by replacing ``SWIN2D_SIZES["base"]``
(read by ``swin2d_config`` when the model is built) in the JAX package's
``models/encoders2d.py`` and in the port's copy, inside the fixture only;
the JAX ``feat_target_size`` is its ``num_features`` (the port sizes its
``fc_mvm`` from the teacher). The JAX masks, negatives and
ScoreHead dropout are replaced as in ``test_torch_pretrain.py``. Also here:
the HF ``SwinModel`` import against the JAX one.
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
from empirical_mvm_tpu.models import encoders2d as jenc
from empirical_mvm_tpu.models import pretrain as jpretrain
from empirical_mvm_tpu.models import violet as jviolet
from empirical_mvm_tpu.models.torch_import import (swin2d_params_from_hf,
                                                   swin3d_params_from_torch,
                                                   violet_params_from_torch)
from empirical_mvm_tpu.train import optimizer as jopt
from empirical_mvm_tpu.train import train_step as jts
from empirical_mvm_torch.core import config as tcfg
from empirical_mvm_torch.data import masking as tmask
from empirical_mvm_torch.models import convert
from empirical_mvm_torch.models import encoders2d as tenc
from empirical_mvm_torch.models.pretrain import VioletPretrain, draw_negatives
from empirical_mvm_torch.train import optimizer as topt
from empirical_mvm_torch.train.train_step import create_train_state, make_pretrain_train_step
from tests.test_torch_pretrain import (B, GRAD_TOL, LOSS_TOL, _batch, _max, _model_cfg,
                                       _np_tree, _t)

# the shrunk teacher: 4 stages (64 / 32 = 2 = the student's grid), a shifted
# block in the two stages wider than the 7 x 7 window, hd = 16
TEACHER = (16, (2, 2, 1, 1), (1, 2, 4, 8))
FEAT = TEACHER[0] * 8
HEADS = {"fc": "score_head", "fc_mtm": "mlm_head", "fc_mvm": "score_head"}
LABELS = topt.GROUPS + (topt.FROZEN,)


def _frozen(name):
    return name.startswith("feature_model.")


@pytest.fixture(scope="module")
def slice_():
    """JAX model and params, the port model carrying them, the batch and
    the fixed draws, with the JAX package's draws replaced by them."""
    batch = _batch()
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jenc.SWIN2D_SIZES, "base", TEACHER)
        mp.setitem(tenc.SWIN2D_SIZES, "base", TEACHER)
        tm = VioletPretrain(_model_cfg(tcfg), mvm_target=("2d_feature",), device="cpu",
                            seed=1)
        gen = torch.Generator().manual_seed(3)
        txt_t = torch.from_numpy(batch["txt"])
        draws = tmask.draw_masks(gen, txt_t, 2, 2, 2, special_token_ids=(101, 102, 0),
                                 mask_token_id=103, p_mask=0.3, mask_types=("bm", "rm"))
        neg_idx = draw_negatives(gen, B, 3)
        mb = tmask.apply_masking(draws, torch.zeros(B, 2, 64, 64, 3), txt_t,
                                 mask_token_id=103)
        pix, cov = mb.mvm_mask.numpy(), mb.cov.numpy()
        new_txt, ans = mb.txt.numpy(), mb.ans_mtm.numpy()

        def fake_apply_masking(key, img, txt, vq, **kw):
            return jmask.MaskedBatch(img=img * (1.0 - jnp.asarray(pix)),
                                     txt=jnp.asarray(new_txt), ans_mtm=jnp.asarray(ans),
                                     ans_mvm=jnp.full((B, 2 * 5), -1, jnp.int32),
                                     mvm_mask=jnp.asarray(pix), cov=jnp.asarray(cov))

        mp.setattr(jmask, "apply_masking", fake_apply_masking)
        mp.setattr(jax.lax, "top_k",
                   lambda x, k: (None, jnp.asarray(neg_idx.numpy(), jnp.int32)))
        mp.setattr(jpretrain, "ScoreHead", functools.partial(jviolet.ScoreHead, dropout=0.0))
        jm = jpretrain.VioletPretrain(config=_model_cfg(jcfg), mvm_target=("2d_feature",),
                                      pretrain_masks=("bm", "rm"), feat_target_size=FEAT)
        args = [jnp.asarray(batch[k]) for k in ("img", "txt", "mask")]
        key = jax.random.PRNGKey(0)
        params = jax.jit(lambda: jm.init({"params": key, "dropout": key, "mask": key},
                                         *args, method=jm.losses)["params"])()
        rs = np.random.RandomState(2)
        params = jax.tree.map(lambda p: np.asarray(p) + 0.05 * rs.randn(*np.shape(p))
                              .astype(np.float32), params)
        tm.load_state_dict(convert.state_dict_from_flax(params, tm.config, HEADS))
        tm.fc[0].p = tm.fc_mvm[0].p = 0.0
        yield dict(jm=jm, params=params, tm=tm, batch=batch, draws=draws,
                   neg_idx=neg_idx, args=args)


def test_weight_carry_round_trip_of_the_2d_feature_tree(slice_):
    """Student and heads back through ``violet_params_from_torch``, the
    teacher through ``swin3d_params_from_torch``, leaf for leaf."""
    params, tm = slice_["params"], slice_["tm"]
    sd = convert.state_dict_from_flax(params, tm.config, HEADS)
    assert set(sd) == set(tm.state_dict())
    assert not any(k.startswith("feature_model.norm") for k in sd)   # final_norm=False
    np_sd = {k: v.numpy() for k, v in sd.items()}
    back = violet_params_from_torch(np_sd, slice_["jm"].config, heads=HEADS)
    # swin3d_params_from_torch always maps a final norm, which a 2D teacher
    # lacks: give it one and drop it again
    c = TEACHER[0] * 8
    back["feature_model"] = swin3d_params_from_torch(
        {**np_sd, "feature_model.norm.weight": np.ones(c), "feature_model.norm.bias":
         np.zeros(c)}, TEACHER[1], prefix="feature_model.")
    del back["feature_model"]["norm"]
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def grads(slice_):
    """Losses and parameter gradients of both sides at the carried params
    (dropout off): JAX's as port-named tensors; the port's None kept."""
    jm, params, tm = slice_["jm"], slice_["params"], slice_["tm"]

    def jloss(p):
        ls = jm.apply({"params": p}, *slice_["args"], method=jm.losses, deterministic=True,
                      rngs={"mask": jax.random.PRNGKey(1)})
        return ls["total"], ls

    jgrads, jls = jax.jit(jax.grad(jloss, has_aux=True))(params)
    b = _t(slice_["batch"])
    tm.zero_grad(set_to_none=True)
    ls = tm.losses(b["img"], b["txt"], b["mask"], draws=slice_["draws"],
                   neg_idx=slice_["neg_idx"])
    ls["total"].backward()
    got = {n: None if p.grad is None else p.grad.clone() for n, p in tm.named_parameters()}
    tm.zero_grad(set_to_none=True)
    return ls, jls, got, convert.state_dict_from_flax(_np_tree(jgrads), tm.config, HEADS)


def test_losses_and_gradients_match_jax(grads):
    ls, jls, got, want = grads
    assert set(ls) == {"mtm", "vtm", "mvm_2d_feature", "total"} == set(jls)
    for k in ls:
        np.testing.assert_allclose(ls[k].item(), float(jls[k]), err_msg=k, **LOSS_TOL)
    assert set(got) == set(want)
    # no gradient: the teacher (no_grad; stop_gradient gives zeros in JAX)
    # and the frame-order embedding, which the pretrain forward does not use
    teacher = {n for n in got if _frozen(n)}
    no_grad = teacher | {"enc_img.emb_odr"}
    assert teacher and {n for n, g in got.items() if g is None} == no_grad
    for name in no_grad:
        assert not want[name].any(), name
    for name, g in got.items():
        if g is not None:
            np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name,
                                       **GRAD_TOL)


def test_optimizer_labels_match_jax_frozen_included(slice_):
    """The port's label of every parameter is the one the JAX
    ``build_optimizer`` gives the leaf mapped onto it: ``frozen`` for the
    teacher, the ``default_group_fn`` group otherwise."""
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
    assert {labels[n] for n in labels} == set(LABELS)
    opt = topt.AdamW(tm, 1e-3, 10)
    state = opt.init(dict(tm.named_parameters()))
    assert not any(_frozen(n) for n in state["mu"]) and set(state["mu"]) == set(state["nu"])
    assert len(state["mu"]) == sum(1 for n, _ in tm.named_parameters() if not _frozen(n))
    # a module the caller freezes is labelled like the teacher
    frozen_head = copy.deepcopy(tm)
    frozen_head.fc_mtm.requires_grad_(False)
    labels = topt.group_labels(frozen_head)
    assert labels["fc_mtm.predictions.decoder.bias"] == topt.FROZEN
    assert labels["fc.3.bias"] == "other_nodecay"


def test_two_train_steps_match_make_pretrain_train_step(slice_, grads):
    """Two steps of both train steps, as in test_torch_pretrain.py (resolved
    elements at 2e-6, the rest within Adam's 2 lr + 2e-6); the teacher is
    bit-unchanged on both sides."""
    jm, params = slice_["jm"], slice_["params"]
    tm = copy.deepcopy(slice_["tm"])
    teacher_before = {n: p.detach().clone() for n, p in tm.named_parameters() if _frozen(n)}
    _, _, got_g, want_g = grads
    tx = jopt.build_optimizer(params, lr=1e-3, max_iter=10)
    jstep = jts.make_pretrain_train_step(jm, tx, mesh=None, donate=False)
    jstate = jts.create_train_state(params, tx)
    jbatch = {k: jnp.asarray(v) for k, v in slice_["batch"].items()}
    opt = topt.AdamW(tm, 1e-3, 10)
    state = create_train_state(tm, opt)
    step = make_pretrain_train_step(tm, opt)
    batch = dict(_t(slice_["batch"]), draws=slice_["draws"], neg_idx=slice_["neg_idx"])
    for _ in range(2):
        jstate, jls = jstep(jstate, jbatch, jax.random.PRNGKey(7))
        state, ls = step(state, batch, 7)
        np.testing.assert_allclose(ls["total"].item(), float(jls["total"]), **LOSS_TOL)
        assert np.isfinite(ls["mvm_2d_feature"].item())
    assert state.step == 2
    jax.tree.map(np.testing.assert_array_equal, _np_tree(jstate.params["feature_model"]),
                 _np_tree(params["feature_model"]))
    want = convert.state_dict_from_flax(_np_tree(jstate.params), tm.config, HEADS)
    resolved_n = 0
    for name, p in tm.named_parameters():
        if _frozen(name):
            assert torch.equal(p.detach(), teacher_before[name]), name
            continue
        g = want_g[name].abs()
        got = got_g[name] if got_g[name] is not None else torch.zeros_like(want_g[name])
        resolved = (g > 100 * (got - want_g[name]).abs()) & (g > 1e-6)
        resolved_n += int(resolved.sum())
        d = (p.detach() - want[name]).abs()
        assert _max(d[resolved]) <= 2e-6, (name, _max(d[resolved]))
        assert _max(d[~resolved]) <= 2e-3 + 2e-6, (name, _max(d[~resolved]))
    trained = [n for n, _ in tm.named_parameters() if not _frozen(n)]
    assert resolved_n > 0.99 * sum(want_g[n].numel() for n in trained) - sum(
        int((want_g[n] == 0).sum()) for n in trained)


def test_pretrain_config_with_2d_feature_builds_the_teacher(monkeypatch):
    """configs/pretrain.json with ``train.mvm_target`` replaced by
    ("2d_feature",), as bench.py builds its model, names a frozen 2D Swin
    teacher (shrunk here) with kernel LayerNorms and no final norm, and the
    fc_mvm head sized to the teacher's features."""
    import dataclasses

    from empirical_mvm_torch.ops.layernorm import FusedLayerNorm, LayerNorm
    run = tcfg.load_run_config("configs/pretrain.json")
    run = dataclasses.replace(run, train=dataclasses.replace(run.train,
                                                             mvm_target=("2d_feature",)))
    monkeypatch.setitem(tenc.SWIN2D_SIZES, "base", TEACHER)
    tiny = dataclasses.replace(run, model=_model_cfg(tcfg))
    m = VioletPretrain.from_run_config(tiny, device="cpu")
    assert m.mvm_target == ("2d_feature",) and not hasattr(m, "decoder_pixel")
    assert m.fc_mvm[3].out_features == FEAT
    assert not any(p.requires_grad for p in m.feature_model.parameters())
    norms = [mod for mod in m.feature_model.modules() if isinstance(mod, LayerNorm)]
    assert norms and all(type(mod) is FusedLayerNorm for mod in norms)
    assert all(type(mod) is LayerNorm for mod in m.enc_img.swin.modules()
               if isinstance(mod, LayerNorm))
    assert m.feature_model.norm is None


def synthetic_hf_swin(depths, heads, e, seed=9):
    """A seeded HF ``SwinModel`` state_dict of the given stages, with the
    final ``layernorm`` that the imports leave out."""
    rs = np.random.RandomState(seed)
    hf = {"embeddings.patch_embeddings.projection.weight": rs.randn(e, 3, 4, 4),
          "embeddings.patch_embeddings.projection.bias": rs.randn(e),
          "embeddings.norm.weight": rs.randn(e), "embeddings.norm.bias": rs.randn(e),
          "layernorm.weight": rs.randn(e * 2 ** (len(depths) - 1)),
          "layernorm.bias": rs.randn(e * 2 ** (len(depths) - 1))}
    for i, depth in enumerate(depths):
        c = e * 2 ** i
        for j in range(depth):
            p = f"encoder.layers.{i}.blocks.{j}."
            for name, shape in (("layernorm_before", (c,)), ("layernorm_after", (c,))):
                hf[p + name + ".weight"], hf[p + name + ".bias"] = rs.randn(*shape), rs.randn(c)
            for name, (o, n_in) in (("attention.self.query", (c, c)),
                                    ("attention.self.key", (c, c)),
                                    ("attention.self.value", (c, c)),
                                    ("attention.output.dense", (c, c)),
                                    ("intermediate.dense", (4 * c, c)),
                                    ("output.dense", (c, 4 * c))):
                hf[p + name + ".weight"], hf[p + name + ".bias"] = rs.randn(o, n_in), rs.randn(o)
            hf[p + "attention.self.relative_position_bias_table"] = rs.randn(169, heads[i])
            hf[p + "attention.self.relative_position_index"] = np.zeros((49, 49), np.int64)
        if i < len(depths) - 1:
            p = f"encoder.layers.{i}.downsample."
            hf[p + "norm.weight"], hf[p + "norm.bias"] = rs.randn(4 * c), rs.randn(4 * c)
            hf[p + "reduction.weight"] = rs.randn(2 * c, 4 * c)
    return {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in hf.items()}


def test_swin2d_state_dict_from_hf_matches_jax_import():
    """A synthetic HF ``SwinModel`` state_dict (two stages, a downsample, the
    final layernorm the import leaves out) through the port's import equals
    the JAX ``swin2d_params_from_hf`` carried by ``swin3d_state_dict``, key
    for key; the port's teacher loads it."""
    depths, heads, e = (2, 1), (2, 4), 16
    hf = synthetic_hf_swin(depths, heads, e)
    got = convert.swin2d_state_dict_from_hf(hf, depths, "feature_model.")
    want = convert.swin3d_state_dict(swin2d_params_from_hf(hf, depths), depths,
                                     "feature_model.")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    teacher = tcfg.SwinConfig(patch_size=(1, 4, 4), embed_dim=e, depths=depths,
                              num_heads=heads, window_size=(1, 7, 7), final_norm=False)
    from empirical_mvm_torch.models.video_swin import SwinTransformer3D
    m = SwinTransformer3D(teacher, fused_norms=True)
    m.load_state_dict(convert.swin2d_state_dict_from_hf(hf, depths))
