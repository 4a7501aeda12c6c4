"""The port's depth, optical_flow and vq pretrain targets against the JAX
package at tiny widths: ``VioletPretrain(mvm_target=("depth",
"optical_flow", "vq"), vq_on_the_fly=True)`` with its frozen DPT, RAFT and
dVAE teachers, and ``("vq",)`` on pre-extracted tokens, carrying the JAX
params through ``state_dict_from_flax``, with the same masks and VTM
negatives on both sides and every dropout and drop-path rate at 0; fp32 on
the CPU.

The teachers are shrunk on both sides by replacing ``DPTDepth`` (4 blocks
of width 128), ``RAFT`` (2 updates; raft_large's widths) and
``DvaeEncoder`` (n_hid 16, 64 tokens) in the JAX teacher modules, which the
JAX model imports when it is built, and in the port's ``models/pretrain``,
inside the module fixture only. The JAX masks, negatives and ScoreHead
dropout are replaced as in ``test_torch_pretrain.py``; the JAX masking's
vq answers, which the replacement must give, are its own formula
(masking.py:186-192), and the port's are held to the real JAX
``apply_masking`` apart.
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
from empirical_mvm_tpu.teachers import dpt as jdpt
from empirical_mvm_tpu.teachers import dvae as jdvae
from empirical_mvm_tpu.teachers import raft as jraft
from empirical_mvm_tpu.train import optimizer as jopt
from empirical_mvm_tpu.train import train_step as jts
from empirical_mvm_torch.core import config as tcfg
from empirical_mvm_torch.data import masking as tmask
from empirical_mvm_torch.models import convert
from empirical_mvm_torch.models import pretrain as tpretrain
from empirical_mvm_torch.models.pretrain import VioletPretrain, draw_negatives
from empirical_mvm_torch.ops.preprocess import maybe_normalize
from empirical_mvm_torch.teachers import dpt as tdpt
from empirical_mvm_torch.teachers import dvae as tdvae
from empirical_mvm_torch.teachers import raft as traft
from empirical_mvm_torch.train import optimizer as topt
from empirical_mvm_torch.train.train_step import create_train_state, make_pretrain_train_step
from tests.test_torch_pretrain import (B, GRAD_TOL, LOSS_TOL, _batch, _max, _model_cfg,
                                       _np_tree, _t)
from tests.test_torch_train_ops import MASK_KW, _jax_draws

# the JAX masking itself, which the module fixture replaces
JAX_APPLY_MASKING = jmask.apply_masking

DPT = dict(vit_dim=128, vit_heads=2, vit_depth=4, hooks=(0, 1, 2, 3),
           reassemble_features=(16, 32, 48, 48), features=32, train_grid=6)
RAFT_UPDATES = 2
VOCAB = 64
DVAE = dict(n_hid=16, n_blk_per_group=1, vocab_size=VOCAB)
TEACHERS = ("depth", "optical_flow", "vq")
HEADS = {"fc": "score_head", "fc_mtm": "mlm_head", "fc_mvm": "score_head",
         "decoder_depth": "linear", "decoder_flow": "linear", "decoder_vq": "linear"}
LABELS = topt.GROUPS + (topt.FROZEN,)
# the fused video tokens of the tiny batch: 2 frames of 1 + 2 x 2
LV = 2 * 5


def _frozen(name):
    return name.startswith(("dpt.", "raft.", "dvae."))


def _vq_tokens():
    """Pre-extracted tokens (B, LV) in [0, VOCAB), the CLS slots included
    (the answers must drop them)."""
    return np.random.RandomState(5).randint(0, VOCAB, (B, LV)).astype(np.int32)


@pytest.fixture(scope="module")
def patched():
    """The batch and the port's draws, with the JAX package's draws and
    ScoreHead dropout replaced, and both packages' teachers shrunk, for the
    whole module."""
    batch = _batch()
    gen = torch.Generator().manual_seed(3)
    txt_t = torch.from_numpy(batch["txt"])
    draws = tmask.draw_masks(gen, txt_t, 2, 2, 2, special_token_ids=(101, 102, 0),
                             mask_token_id=103, p_mask=0.3, mask_types=("bm", "rm"))
    neg_idx = draw_negatives(gen, B, 3)
    mb = tmask.apply_masking(draws, torch.zeros(B, 2, 64, 64, 3), txt_t, mask_token_id=103)
    pix, cov = mb.mvm_mask.numpy(), mb.cov.numpy()
    new_txt, ans = mb.txt.numpy(), mb.ans_mtm.numpy()
    cov_full = np.concatenate([np.zeros((B, 2, 1), np.float32), cov.reshape(B, 2, 4)],
                              axis=2).reshape(B, LV)

    def fake_apply_masking(key, img, txt, vq, **kw):
        ans_mvm = (jnp.full((B, LV), -1, jnp.int32) if vq is None
                   else jnp.where(cov_full > 0, vq, -1).astype(jnp.int32))
        return jmask.MaskedBatch(img=img * (1.0 - jnp.asarray(pix)), txt=jnp.asarray(new_txt),
                                 ans_mtm=jnp.asarray(ans), ans_mvm=ans_mvm,
                                 mvm_mask=jnp.asarray(pix), cov=jnp.asarray(cov))

    with pytest.MonkeyPatch.context() as mp:
        for dpt, raft, dvae, where in ((jdpt, jraft, jdvae, (jdpt, jraft, jdvae)),
                                       (tdpt, traft, tdvae, (tpretrain,) * 3)):
            mp.setattr(where[0], "DPTDepth", functools.partial(dpt.DPTDepth, **DPT))
            mp.setattr(where[1], "RAFT", functools.partial(raft.RAFT, num_updates=RAFT_UPDATES))
            mp.setattr(where[2], "DvaeEncoder", functools.partial(dvae.DvaeEncoder, **DVAE))
        mp.setattr(jmask, "apply_masking", fake_apply_masking)
        mp.setattr(jax.lax, "top_k",
                   lambda x, k: (None, jnp.asarray(neg_idx.numpy(), jnp.int32)))
        mp.setattr(jpretrain, "ScoreHead", functools.partial(jviolet.ScoreHead, dropout=0.0))
        yield dict(batch=batch, draws=draws, neg_idx=neg_idx, pix=pix,
                   args=[jnp.asarray(batch[k]) for k in ("img", "txt", "mask")])


# added to the x delta of each RAFT update (the flow head's output bias):
# after 2 updates the pairs' largest flows read 50.12, 50.63, 48.84 and
# 49.78 pixels, so that the loss's 50-pixel filter drops two of the four
FLOW_SHIFT = 3.08


def _noise(rs):
    """N(0, 0.05) around the init; the batch-norm variances kept positive;
    RAFT's last flow-head kernel scaled by 0.1, so that the updates stay
    smooth (tests/test_torch_raft.py), and its x bias shifted by
    ``FLOW_SHIFT``."""
    def noise(path, p):
        keys = [k.key for k in path]
        p = np.asarray(p) + 0.05 * rs.randn(*np.shape(p)).astype(np.float32)
        if keys[-1] == "var":
            return np.abs(p) + 0.5
        if keys[:3] == ["raft", "flow_head", "conv2"]:
            return 0.1 * p if keys[-1] == "kernel" else p + np.float32([FLOW_SHIFT, 0.0])
        return p
    return noise


def _carried(patched, targets, on_the_fly):
    """JAX model and params for ``targets``, and the port model carrying
    them (score-head dropout off)."""
    jm = jpretrain.VioletPretrain(config=_model_cfg(jcfg), mvm_target=targets,
                                  pretrain_masks=("bm", "rm"), size_vq=VOCAB,
                                  vq_on_the_fly=on_the_fly)
    key = jax.random.PRNGKey(0)
    vq = None if on_the_fly else jnp.asarray(_vq_tokens())
    params = jax.jit(lambda: jm.init({"params": key, "dropout": key, "mask": key},
                                     *patched["args"], vq, method=jm.losses)["params"])()
    params = jax.tree_util.tree_map_with_path(_noise(np.random.RandomState(2)), params)
    tm = VioletPretrain(_model_cfg(tcfg), mvm_target=targets, size_vq=VOCAB,
                        vq_on_the_fly=on_the_fly, device="cpu", seed=1)
    heads = {k: v for k, v in HEADS.items() if k in params}
    tm.load_state_dict(convert.state_dict_from_flax(params, tm.config, heads))
    if "dvae" in params:
        # the random encoder's ReLU features share a large mean, along which
        # one token outscores the rest in every cell; the output bias that
        # cancels the batch's mean feature lets the cells' differences pick
        img = maybe_normalize(torch.from_numpy(patched["batch"]["img"]))
        x = tdvae.map_pixels(tdvae.unnormalize_imagenet(img).clamp(0, 1))
        with torch.no_grad():
            mean = tm.dvae.features(x.reshape(-1, 64, 64, 3)).mean(dim=(0, 1, 2))
        out = params["dvae"]["output"]["conv"]
        out["bias"] = -(mean.numpy() @ np.asarray(out["kernel"])[0, 0])
        tm.load_state_dict(convert.state_dict_from_flax(params, tm.config, heads))
    tm.fc[0].p = tm.fc_mvm[0].p = 0.0
    return dict(jm=jm, params=params, tm=tm, heads=heads, vq=vq)


@pytest.fixture(scope="module")
def teachers(patched):
    return _carried(patched, TEACHERS, True)


@pytest.fixture(scope="module")
def pre_extracted(patched):
    return _carried(patched, ("vq",), False)


def _losses_and_grads(patched, carried):
    """Losses and parameter gradients of both sides (dropout off): JAX's as
    port-named tensors (the batch-norm statistics, buffers in the port, left
    out); the port's None kept."""
    jm, params, tm, vq = carried["jm"], carried["params"], carried["tm"], carried["vq"]

    def jloss(p):
        ls = jm.apply({"params": p}, *patched["args"], vq, method=jm.losses,
                      deterministic=True, rngs={"mask": jax.random.PRNGKey(1)})
        return ls["total"], ls

    jgrads, jls = jax.jit(jax.grad(jloss, has_aux=True))(params)
    b = _t(patched["batch"])
    tm.zero_grad(set_to_none=True)
    ls = tm.losses(b["img"], b["txt"], b["mask"], draws=patched["draws"],
                   neg_idx=patched["neg_idx"], vq=None if vq is None else torch.from_numpy(
                       np.asarray(vq)))
    ls["total"].backward()
    got = {n: None if p.grad is None else p.grad.clone() for n, p in tm.named_parameters()}
    tm.zero_grad(set_to_none=True)
    want = convert.state_dict_from_flax(_np_tree(jgrads), tm.config, carried["heads"])
    return ls, jls, got, {n: g for n, g in want.items() if n in got}


@pytest.fixture(scope="module")
def grads(patched, teachers):
    return _losses_and_grads(patched, teachers)


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


def test_weight_carry_round_trip_of_the_teacher_tree(teachers):
    """The port's state_dict (the teachers' batch-norm statistics as
    buffers) is what ``state_dict_from_flax`` gives; the teachers back
    through the JAX importers, leaf for leaf."""
    params, tm = teachers["params"], teachers["tm"]
    sd = convert.state_dict_from_flax(params, tm.config, HEADS)
    assert set(sd) == set(tm.state_dict())
    np_sd = {k: v.numpy() for k, v in sd.items()}

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in np_sd.items() if k.startswith(prefix)}

    back = {"dpt": jdpt.dpt_params_from_torch(sub("dpt."), vit_depth=DPT["vit_depth"]),
            "dvae": jdvae.dvae_params_from_torch(sub("dvae."),
                                                 n_blk_per_group=DVAE["n_blk_per_group"]),
            "raft": jraft.raft_params_from_torch(sub("raft."))}
    for name, tree in back.items():
        want = dict(jax.tree_util.tree_leaves_with_path(params[name]))
        got = dict(jax.tree_util.tree_leaves_with_path(tree))
        assert set(got) == set(want), name
        for path, leaf in want.items():
            np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf),
                                          err_msg=name + jax.tree_util.keystr(path))


def test_teacher_targets_are_live(patched, teachers):
    """The targets the losses read are not degenerate: depth positive
    somewhere, two of the four pairs' RAFT flows under the 50-pixel filter
    and two over it, more than a few distinct dVAE tokens among the covered
    cells."""
    tm, b = teachers["tm"], _t(patched["batch"])
    img = maybe_normalize(b["img"])
    with torch.no_grad():
        depth = tm.dpt(img.reshape(-1, 64, 64, 3))
        flow = tm.raft(img[:, 0], img[:, 1])
        ans = tm.vq_answers(img, torch.from_numpy(patched["pix"]))
    assert (depth > 0).float().mean() > 0.1
    mag = flow.abs().amax(dim=(1, 2, 3))
    assert (mag < 50).tolist() == [False, False, True, True], mag
    assert len(torch.unique(ans[ans >= 0])) > 5


def test_losses_and_gradients_match_jax(grads):
    teachers = _hold_losses_and_grads(*grads, ("mvm_depth", "mvm_flow", "mvm_vq"))
    assert {n.split(".")[0] for n in teachers} == {"dpt", "raft", "dvae"}


def test_pre_extracted_vq_matches_jax(patched, pre_extracted):
    """("vq",) on given tokens: ``fc_mvm`` classifies the fused video
    tokens against the answers of the covered patches; no teacher."""
    ls, jls, got, want = _losses_and_grads(patched, pre_extracted)
    _hold_losses_and_grads(ls, jls, got, want, ("mvm_vq",))
    assert not any(_frozen(n) for n in got)


def test_masking_vq_answers_match_jax():
    """The port's ``apply_masking`` with pre-extracted tokens against the
    real JAX ``apply_masking`` given its draws: the answers are the tokens
    of the covered patches, -1 elsewhere and at every frame's CLS slot."""
    rs = np.random.RandomState(6)
    b, t, hh = 6, 3, 96
    img = rs.rand(b, t, hh, hh, 3).astype(np.float32)
    txt = rs.randint(104, 500, (b, 12)).astype(np.int32)
    txt[:, 0], txt[:, 9], txt[:, 10:] = 101, 102, 0
    vq = rs.randint(0, 8192, (b, t * 10)).astype(np.int32)
    key = jax.random.PRNGKey(4)
    ref = JAX_APPLY_MASKING(key, jnp.asarray(img), jnp.asarray(txt), jnp.asarray(vq),
                              patch_size=32, p_mask=0.3, mask_types=("bm", "rm"), **MASK_KW)
    draws = _jax_draws(key, b, t, 3, 3, jnp.asarray(txt), 0.3, ("bm", "rm"))
    out = tmask.apply_masking(draws, torch.from_numpy(img), torch.from_numpy(txt),
                              torch.from_numpy(vq), mask_token_id=103, patch_size=32)
    want = np.asarray(ref.ans_mvm)
    np.testing.assert_array_equal(out.ans_mvm.numpy(), want)
    assert (want.reshape(b, t, 10)[:, :, 0] == -1).all() and (want >= 0).any()
    none = tmask.apply_masking(draws, torch.from_numpy(img), torch.from_numpy(txt),
                               mask_token_id=103, patch_size=32)
    assert (none.ans_mvm == -1).all() and none.ans_mvm.dtype == torch.int32


def test_a_given_vq_replaces_the_teachers_tokens(patched, teachers):
    """``losses(vq=...)`` with ``vq_on_the_fly``: the dVAE's own tokens
    given back leave every loss as it was; other tokens change the vq loss
    alone."""
    tm, b = teachers["tm"], _t(patched["batch"])
    img = maybe_normalize(b["img"])
    kw = dict(draws=patched["draws"], neg_idx=patched["neg_idx"])
    with torch.no_grad():
        own_tokens = tm.dvae.extract_vq_tokens(img.reshape(-1, 64, 64, 3)).reshape(B, 2, 8, 8)
        own = tm.losses(b["img"], b["txt"], b["mask"], **kw)
        given = tm.losses(b["img"], b["txt"], b["mask"], vq=own_tokens, **kw)
        other = tm.losses(b["img"], b["txt"], b["mask"], vq=(own_tokens + 1) % VOCAB, **kw)
    assert given.keys() == own.keys()
    for k in own:
        assert given[k].item() == own[k].item(), k
    assert other["mvm_vq"].item() != own["mvm_vq"].item()
    for k in ("mtm", "vtm", "mvm_depth", "mvm_flow"):
        assert other[k].item() == own[k].item(), k


def test_optimizer_labels_the_teachers_frozen(teachers):
    """Every parameter's label is the one the JAX ``build_optimizer`` gives
    the leaf mapped onto it: ``frozen`` for the three teachers, which get no
    Adam moments."""
    tm = teachers["tm"]

    def jlabel(path):
        keys = tuple(k.key for k in path)
        if jopt._is_frozen(".".join(keys), ()):
            return topt.FROZEN
        return jopt.default_group_fn(keys)

    codes = jax.tree_util.tree_map_with_path(
        lambda path, x: np.full(np.shape(x), LABELS.index(jlabel(path)), np.float32),
        teachers["params"])
    want = convert.state_dict_from_flax(codes, tm.config, HEADS)
    labels = topt.group_labels(tm)
    assert set(labels) == set(want) - {n for n, _ in tm.named_buffers()}
    for name, label in labels.items():
        assert (want[name] == LABELS.index(label)).all(), name
    assert {labels[n] for n in labels if _frozen(n)} == {topt.FROZEN}
    state = topt.AdamW(tm, 1e-3, 10).init(dict(tm.named_parameters()))
    assert not any(_frozen(n) for n in state["mu"])


def test_two_train_steps_match_make_pretrain_train_step(patched, teachers, grads):
    """Two steps of both train steps, held as ``assert_two_steps_match`` in
    test_torch_pretrain.py holds them: resolved elements at 2e-6 but for at
    most 1e-4 of them (fp32 roundoff through two Adam updates), every
    element within Adam's 2 lr + 2e-6; the three teachers bit-unchanged on
    both sides, their batch-norm statistics too."""
    jm, params = teachers["jm"], teachers["params"]
    tm = copy.deepcopy(teachers["tm"])
    before = {n: t.detach().clone() for n, t in tm.state_dict().items() if _frozen(n)}
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
        assert all(np.isfinite(ls[k].item()) for k in ("mvm_depth", "mvm_flow", "mvm_vq"))
    assert state.step == 2
    for teacher in ("dpt", "raft", "dvae"):
        jax.tree.map(np.testing.assert_array_equal, _np_tree(jstate.params[teacher]),
                     _np_tree(params[teacher]))
    for name, t in tm.state_dict().items():
        if _frozen(name):
            assert torch.equal(t, before[name]), name
    want = convert.state_dict_from_flax(_np_tree(jstate.params), tm.config, teachers["heads"])
    resolved_n, over = 0, []
    for name, p in tm.named_parameters():
        if _frozen(name):
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
