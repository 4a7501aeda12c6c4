"""The port's multiple-choice QA slice (``VioletQAMC``, the ``ce`` fine-tune
step, ``qamc_accuracy``, the run's ``freeze`` prefixes) against the JAX
package at tiny widths on the CPU, fp32; inputs from numpy with a seed.

The model: Video Swin at embed 32 (stages 0-1 take the packed window
kernel, 2-3 the direct one), depths 1/1/1/1, a 2-layer BERT of hidden 32
(no multiple of 128, so both packages route its attention to the tiled
self-attention, row 11), 2 questions of 3 options of 8 tokens over 2 frames
of 64^2. Dropout, drop path and the score head's dropout are 0 on both sides
wherever a step runs (the JAX ScoreHead's rate, fixed at 0.1, is replaced
inside the fixture).
"""

import dataclasses
import functools

import numpy as np
import optax
import pytest
import torch

import tests.conftest  # noqa: F401  (pins JAX to the CPU)
from tests.torch_threads import torch_threads  # noqa: F401  (the cores' share under xdist)

import jax
import jax.numpy as jnp

from empirical_mvm_tpu.core import config as jcfg
from empirical_mvm_tpu.models import tasks as jtasks
from empirical_mvm_tpu.models import violet as jviolet
from empirical_mvm_tpu.models.torch_import import violet_params_from_torch
from empirical_mvm_tpu.train import evaluators as jeval
from empirical_mvm_tpu.train import losses as jlosses
from empirical_mvm_tpu.train import optimizer as jopt
from empirical_mvm_torch.core import config as tcfg
from empirical_mvm_torch.models import convert
from empirical_mvm_torch.models.tasks import VioletQAMC
from empirical_mvm_torch.train import evaluators as teval
from empirical_mvm_torch.train import optimizer as topt
from empirical_mvm_torch.train.train_step import (create_train_state, make_eval_step,
                                                  make_supervised_train_step)

BERT = dict(vocab_size=200, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
SWIN = dict(embed_dim=32, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), drop_path_rate=0.0)
HEADS = {"fc": "score_head"}          # what cli/qa.py passes for qamc
B, O, X = 2, 3, 8
LOSS_TOL = dict(atol=1e-5, rtol=1e-4)
GRAD_TOL = dict(atol=2e-4, rtol=1e-3)  # fp32 summation order through the model
LR, MAX_ITER = 1e-3, 10
LABELS = topt.GROUPS + (topt.FROZEN,)


def _model_cfg(c):
    return c.ModelConfig(size_img=64, size_frame=2, size_txt=X, size_option=O,
                         fusion=c.BertConfig(**BERT), text=c.BertConfig(**BERT),
                         swin_custom=c.SwinConfig(**SWIN))


def _batch():
    rs = np.random.RandomState(0)
    txt = rs.randint(104, 200, (B, O, X)).astype(np.int32)
    txt[..., 0] = 101
    for i, n in enumerate(rs.randint(4, X + 1, B * O)):
        txt.reshape(-1, X)[i, n - 1], txt.reshape(-1, X)[i, n:] = 102, 0
    return {"img": rs.randint(0, 256, (B, 2, 64, 64, 3)).astype(np.uint8), "txt": txt,
            "mask": (txt > 0).astype(np.int32), "ans": np.array([2, 0], np.int32)}


@pytest.fixture(scope="module")
def slice_():
    """The JAX VioletQAMC and its params (perturbed from their init), the
    port model carrying them, and the batch; the JAX ScoreHead dropout is 0
    while the generator is suspended."""
    batch = _batch()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtasks, "ScoreHead", functools.partial(jviolet.ScoreHead, dropout=0.0))
        jm = jtasks.VioletQAMC(config=_model_cfg(jcfg))
        args = [jnp.asarray(batch[k]) for k in ("img", "txt", "mask")]
        params = jax.jit(lambda: jm.init(jax.random.PRNGKey(0), *args)["params"])()
        rs = np.random.RandomState(1)
        params = jax.tree.map(lambda p: np.asarray(p) + 0.05 * rs.randn(*np.shape(p))
                              .astype(np.float32), params)
        tm = VioletQAMC(_model_cfg(tcfg), device="cpu", seed=2)
        tm.load_state_dict(convert.state_dict_from_flax(params, tm.config, HEADS))
        tm.fc[0].p = 0.0
        yield dict(jm=jm, params=params, tm=tm, batch=batch, args=args)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_weight_carry_round_trip_of_the_qamc_tree(slice_):
    params, tm = slice_["params"], slice_["tm"]
    sd = convert.state_dict_from_flax(params, tm.config, HEADS)
    assert set(sd) == set(tm.state_dict())
    back = violet_params_from_torch({k: v.numpy() for k, v in sd.items()},
                                    slice_["jm"].config, heads=HEADS)
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


def test_qamc_forward_and_accuracy_match_jax_kernels(slice_, monkeypatch):
    """The eval forward against JAX with its Pallas kernels in interpret
    mode (the tiled self-attention in the fusion, the packed and direct
    window kernels in the swin, the kernel LayerNorms); the accuracy of
    both packages' logits equal."""
    monkeypatch.setenv("EMVM_PALLAS_INTERPRET", "1")
    jm, params = slice_["jm"], slice_["params"]
    want = np.asarray(jax.jit(lambda p: jm.apply({"params": p}, *slice_["args"]))(params))
    got = make_eval_step(slice_["tm"])(_t(slice_["batch"]))
    assert got.shape == (B, O) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)
    for ans in (slice_["batch"]["ans"], np.argmax(want, 1), np.argmin(want, 1)):
        acc = teval.qamc_accuracy(got.numpy(), ans)
        assert acc == jeval.qamc_accuracy(want, ans)
    assert teval.qamc_accuracy(got.numpy(), np.argmax(want, 1)) == 1.0
    # the gumbel video-token selection adds its two bias-free projections
    # (held against JAX in tests/test_torch_qa_heads.py)
    gumbel = VioletQAMC(_model_cfg(tcfg), device="cpu", num_video_tokens=4)
    assert set(gumbel.state_dict()) - set(slice_["tm"].state_dict()) == {"vid_key.weight",
                                                                         "vid_query.weight"}


def _jax_step(jm, tx, batch):
    """One ``QAMCAgent`` step of the JAX package, from its pieces:
    ``value_and_grad`` of ``cross_entropy_ignore`` over the training pass,
    then the optax update. Returns (params, opt_state, loss, grads)."""
    img, txt, mask, ans = (jnp.asarray(batch[k]) for k in ("img", "txt", "mask", "ans"))

    def step(params, opt_state):
        def loss_fn(p):
            out = jm.apply({"params": p}, img, txt, mask, deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(7)})
            return jlosses.cross_entropy_ignore(out, ans)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    return jax.jit(step)


def _run(cfg_dict):
    raw = {"lr": LR, **cfg_dict}
    return jcfg.load_run_config(raw), tcfg.load_run_config(raw)


def _jax_labels(params, freeze):
    """The label ``build_optimizer`` gives each leaf (its ``label_one``)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: np.full(np.shape(x), LABELS.index(
            "frozen" if jopt._is_frozen(".".join(k.key for k in path), freeze)
            else jopt.default_group_fn(tuple(k.key for k in path))), np.float32), params)


def _jax_tx(params, train):
    return jopt.build_optimizer(params, lr=train.lr, max_iter=MAX_ITER,
                                weight_decay=train.decay, betas=train.betas,
                                warmup_ratio=train.warmup_ratio, min_lr=train.min_lr,
                                max_grad_norm=train.max_grad_norm,
                                backbone_lr_mul=train.vis_backbone_lr_mul,
                                freeze_prefixes=tuple(train.freeze))


def test_two_ce_steps_match_the_jax_qamc_step(slice_):
    """Two ``make_supervised_train_step("ce")`` steps against the JAX
    QAMCAgent step at rates 0. Step 0 runs at lr(0) = min_lr, step 1 at
    lr = 1e-3. The loss of each step at rtol 1e-4, step 0's gradients at
    atol 2e-4 / rtol 1e-3; the parameters after each step: elements whose
    gradient is resolved (above 100x the two sides' gradient difference and
    1e-6) within 2e-6, the rest within Adam's bound of 2 lr + 2e-6 (their
    gradient is at the level of fp32 roundoff, such as the key biases' and
    the score head's output bias, zero in exact arithmetic). As in
    test_torch_packed_window.py, at most 1e-4 of the resolved elements may
    exceed 2e-6 (still within Adam's bound): a few whose step-1 gradient
    nearly cancels move by up to +-lr on either side."""
    jm, params = slice_["jm"], slice_["params"]
    jrun, trun = _run({})
    tm = VioletQAMC(_model_cfg(tcfg), device="cpu", seed=3)
    tm.load_state_dict(slice_["tm"].state_dict())
    tm.fc[0].p = 0.0
    tx = _jax_tx(params, jrun.train)
    jstep = _jax_step(jm, tx, slice_["batch"])
    opt = topt.build_optimizer(tm, trun.train, MAX_ITER)
    state = create_train_state(tm, opt)
    step = make_supervised_train_step(tm, opt, "ce")
    batch = _t(slice_["batch"])
    jparams, jopt_state = params, tx.init(params)
    for i in range(2):
        jparams, jopt_state, jloss, jgrads = jstep(jparams, jopt_state)
        state, ls = step(state, batch, 7)
        np.testing.assert_allclose(ls["total"].item(), float(jloss), **LOSS_TOL)
        want_g = convert.state_dict_from_flax(jax.tree.map(np.asarray, jgrads), tm.config, HEADS)
        got_g = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in tm.named_parameters()}
        # the frame-order embedding is unused by the forward
        assert {n for n, p in tm.named_parameters() if p.grad is None} == {"enc_img.emb_odr"}
        if i == 0:
            grads0 = (got_g, want_g)
            for name, g in got_g.items():
                np.testing.assert_allclose(g.numpy(), want_g[name].numpy(), err_msg=name,
                                           **GRAD_TOL)
        want = convert.state_dict_from_flax(jax.tree.map(np.asarray, jparams), tm.config, HEADS)
        resolved_n, over = 0, []
        for name, p in tm.named_parameters():
            g0, w0 = grads0[0][name], grads0[1][name].abs()
            resolved = (w0 > 100 * (g0 - grads0[1][name]).abs()) & (w0 > 1e-6)
            resolved_n += int(resolved.sum())
            d = (p.detach() - want[name]).abs()
            assert d.max().item() <= 2 * LR + 2e-6, (i, name)
            if resolved.any() and d[resolved].max().item() > 2e-6:
                over.append((name, int((d[resolved] > 2e-6).sum()), d[resolved].max().item()))
        assert sum(n for _, n, _ in over) <= 1e-4 * resolved_n, (i, over)
    assert state.step == 2


def _freeze_steps(tm, train, batch, ref=False):
    """Two ``ce`` steps of ``tm`` under ``train`` (step 1 runs at the full
    lr); ``ref``: first turn off ``requires_grad`` of the parameters under
    the ``freeze`` prefixes, as the PyTorch reference freezes them, so that
    they get no gradient. Returns the optimizer."""
    if ref:
        for name, p in tm.named_parameters():
            p.requires_grad_(not name.startswith(tuple(train.freeze)))
    opt = topt.build_optimizer(tm, train, MAX_ITER)
    state = create_train_state(tm, opt)
    for _ in range(2):
        state, _ = make_supervised_train_step(tm, opt)(state, _t(batch), 7)
    return opt


def test_freeze_violet_labels_and_frozen_parameters_match_jax(slice_):
    """``{"freeze_violet": true}`` through both config loaders, at
    ``max_grad_norm`` 1e-4, far under the gradient's norm, so the clip acts
    on every step: the port's optimizer labels equal the JAX
    ``build_optimizer`` labels leaf for leaf (the trunk frozen, the score
    head trained); after two steps the frozen parameters are bit-unchanged
    on both sides, and the head equals the JAX head within 2e-6. The JAX
    clip counts the frozen parameters' gradients; a port that computed none
    (the PyTorch reference's ``requires_grad_(False)``) clips the head by
    its own norm alone and lands more than 1e-4 away."""
    jm, params = slice_["jm"], slice_["params"]
    jrun, trun = _run({"freeze_violet": True, "max_grad_norm": 1e-4})
    assert tuple(jrun.train.freeze) == trun.train.freeze == ("enc_img", "enc_txt", "trsfr")
    models = []
    for _ in range(2):
        tm = VioletQAMC(_model_cfg(tcfg), device="cpu", seed=3)
        tm.load_state_dict(slice_["tm"].state_dict())
        tm.fc[0].p = 0.0
        models.append(tm)
    tm, ref = models
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    opt = _freeze_steps(tm, trun.train, slice_["batch"])
    _freeze_steps(ref, trun.train, slice_["batch"], ref=True)
    want = convert.state_dict_from_flax(_jax_labels(params, tuple(jrun.train.freeze)),
                                        tm.config, HEADS)
    for name, code in want.items():
        assert (code == LABELS.index(opt.labels[name])).all(), (name, opt.labels[name])
    head = {"fc.1.weight", "fc.1.bias", "fc.3.weight", "fc.3.bias"}
    assert {n for n, lab in opt.labels.items() if lab != topt.FROZEN} == head
    tx = _jax_tx(params, jrun.train)
    jstep = _jax_step(jm, tx, slice_["batch"])
    jparams, jstate = params, tx.init(params)
    for _ in range(2):
        jparams, jstate, _, _ = jstep(jparams, jstate)
    jafter = convert.state_dict_from_flax(jax.tree.map(np.asarray, jparams), tm.config, HEADS)
    jbefore = convert.state_dict_from_flax(params, tm.config, HEADS)
    refp = dict(ref.named_parameters())
    for name, p in tm.named_parameters():
        if name in head:
            assert not torch.equal(p.detach(), before[name]), name
            np.testing.assert_allclose(p.detach().numpy(), jafter[name].numpy(), atol=2e-6,
                                       rtol=0, err_msg=name)
        else:
            assert torch.equal(p.detach(), before[name]), name
            assert torch.equal(jafter[name], jbefore[name]), name
            assert p.grad is not None or name == "enc_img.emb_odr", name
    assert max((refp[n].detach() - jafter[n]).abs().max().item() for n in head) > 1e-4
    accum = topt.build_optimizer(tm, dataclasses.replace(trun.train, grad_accum=2), MAX_ITER)
    assert accum.grad_accum == 2 and accum.labels == opt.labels


def test_freeze_prefixes_name_jax_paths_and_teachers():
    """A prefix is a JAX tree path (``layer_0``), matched on the port's
    names (``layer.0``) at component boundaries; teacher modules are frozen
    wherever they sit, as ``_is_frozen`` has it."""
    names = ["trsfr.layer.0.output.dense.weight", "trsfr.layer.10.output.dense.weight",
             "feature_model.layers.0.blocks.0.norm1.weight", "enc_img.swin.norm.bias",
             "x.clip_model.proj.weight", "fc.1.weight"]
    prefixes = tuple(topt.port_path(p) for p in ("trsfr.layer_0",))
    for name in names:
        jax_name = name.replace("layer.0.", "layer_0.").replace("layer.10.", "layer_10.")
        assert topt._is_frozen(name, prefixes) == jopt._is_frozen(jax_name, ("trsfr.layer_0",))
    assert [topt._is_frozen(n, prefixes) for n in names] == [True, False, True, False, True,
                                                             False]
