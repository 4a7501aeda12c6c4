"""The port's pretrain slice against the JAX package at tiny widths: a
``VioletPretrain`` (pixel target) carrying the JAX params through
``state_dict_from_flax``, with the same masks and VTM negatives on both
sides and every dropout and drop-path rate at 0; fp32 on the CPU.

The JAX side draws its masks and negatives inside its jitted step; the tests
replace ``apply_masking`` and ``jax.lax.top_k`` there with the port's draws
(the JAX package itself is unchanged), and its ScoreHead dropout, fixed at
0.1 there, with 0.
"""

import copy
import dataclasses
import functools

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (pins JAX to the CPU)

import jax
import jax.numpy as jnp

from empirical_mvm_tpu.core import config as jcfg
from empirical_mvm_tpu.data import masking as jmask
from empirical_mvm_tpu.models import pretrain as jpretrain
from empirical_mvm_tpu.models import violet as jviolet
from empirical_mvm_tpu.models.torch_import import violet_params_from_torch
from empirical_mvm_tpu.train import optimizer as jopt
from empirical_mvm_tpu.train import train_step as jts
from empirical_mvm_torch.core import config as tcfg
from empirical_mvm_torch.data import masking as tmask
from empirical_mvm_torch.models import convert
from empirical_mvm_torch.models.pretrain import VioletPretrain, draw_negatives
from empirical_mvm_torch.train import optimizer as topt
from empirical_mvm_torch.train.train_step import create_train_state, make_pretrain_train_step

BERT = dict(vocab_size=200, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
SWIN = dict(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), drop_path_rate=0.0)
HEADS = {"fc": "score_head", "fc_mtm": "mlm_head", "decoder_pixel": "linear"}
B = 4
LOSS_TOL = dict(atol=1e-5, rtol=1e-4)
# every gradient: fp32 summation order through the whole model
GRAD_TOL = dict(atol=2e-4, rtol=1e-3)


def _model_cfg(c):
    return c.ModelConfig(size_img=64, size_frame=2, size_txt=8,
                         fusion=c.BertConfig(**BERT), text=c.BertConfig(**BERT),
                         swin_custom=c.SwinConfig(**SWIN))


def _batch():
    rs = np.random.RandomState(0)
    txt = rs.randint(104, 200, (B, 8)).astype(np.int32)
    txt[:, 0] = 101
    lens = [8, 6, 5, 7]
    for i, n in enumerate(lens):
        txt[i, n - 1], txt[i, n:] = 102, 0
    return {"img": rs.randint(0, 256, (B, 2, 64, 64, 3)).astype(np.uint8), "txt": txt,
            "mask": (txt > 0).astype(np.int32)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def drawn_params(shapes, rs):
    """A flax parameter tree of ``shapes`` (``jax.eval_shape`` of an
    ``init``) drawn on the host, in place of compiling the ``init``: the
    port's ``init_weights`` (LayerNorm ``scale`` 1, biases 0, the rest
    N(0, 0.02)) moved by N(0, 0.05), as the carried slices move theirs."""
    def draw(path, s):
        leaf = path[-1].key
        base = (np.ones(s.shape) if leaf == "scale" else np.zeros(s.shape) if leaf == "bias"
                else 0.02 * rs.randn(*s.shape))
        return (base + 0.05 * rs.randn(*s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def carried_slice(model_cfg, pretrain_tasks=("mtm", "vtm", "mvm"),
                  pretrain_masks=("bm", "rm"), drawn=None):
    """JAX model and params for the tiny ``model_cfg(package)`` (pixel
    target, ``pretrain_tasks``, ``pretrain_masks``), the port model carrying
    them, the batch, and the fixed draws, with the JAX package's draws
    replaced by them while the generator is suspended (a module fixture
    yields from it). An ``am`` draw reads seeded scores in place of a
    rollout (``tests/test_torch_am_masking.py`` holds the rollout). The
    params are the JAX ``init``'s moved by N(0, 0.05), or with ``drawn``,
    ``drawn(shapes)`` of the ``init``'s ``jax.eval_shape``, so that no
    ``init`` compiles."""
    batch = _batch()
    tm = VioletPretrain(model_cfg(tcfg), pretrain_tasks=pretrain_tasks,
                        pretrain_masks=pretrain_masks, device="cpu", seed=1)
    gen = torch.Generator().manual_seed(3)
    txt_t = torch.from_numpy(batch["txt"])
    scores = torch.rand((B, 2 * 5 + 8), generator=gen) if "am" in pretrain_masks else None
    draws = tmask.draw_masks(gen, txt_t, 2, 2, 2, special_token_ids=(101, 102, 0),
                             mask_token_id=103, p_mask=0.3, mask_types=pretrain_masks,
                             att_scores=scores)
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
        mp.setattr(jmask, "apply_masking", fake_apply_masking)
        mp.setattr(jax.lax, "top_k",
                   lambda x, k: (None, jnp.asarray(neg_idx.numpy(), jnp.int32)))
        mp.setattr(jpretrain, "ScoreHead", functools.partial(jviolet.ScoreHead, dropout=0.0))
        jm = jpretrain.VioletPretrain(config=model_cfg(jcfg), mvm_target=("pixel",),
                                      pretrain_tasks=tuple(pretrain_tasks),
                                      pretrain_masks=tuple(pretrain_masks))
        args = [jnp.asarray(batch[k]) for k in ("img", "txt", "mask")]
        key = jax.random.PRNGKey(0)

        def init():
            return jm.init({"params": key, "dropout": key, "mask": key}, *args,
                           method=jm.losses)["params"]

        if drawn is not None:
            params = drawn(jax.eval_shape(init))
        else:
            rs = np.random.RandomState(2)
            params = jax.tree.map(lambda p: np.asarray(p) + 0.05 * rs.randn(*np.shape(p))
                                  .astype(np.float32), jax.jit(init)())
        tm.load_state_dict(convert.state_dict_from_flax(params, tm.config, HEADS))
        tm.fc[0].p = 0.0
        yield dict(jm=jm, params=params, tm=tm, batch=batch, draws=draws,
                   neg_idx=neg_idx, args=args)


@pytest.fixture(scope="module")
def slice_():
    """JAX model and params, the port model carrying them, the batch, and
    the fixed draws, with the JAX package's draws replaced by them."""
    yield from carried_slice(_model_cfg)


def _max(t):
    return t.max().item() if t.numel() else 0.0


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_weight_carry_round_trip_of_the_pretrain_tree(slice_):
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


def losses_and_grads(slice_, heads=HEADS, train=False):
    """Losses and parameter gradients of both sides at the carried params
    (dropout off): JAX's as port-named tensors, the port's None as zeros;
    and the names of the port's parameters without a gradient. ``train``:
    the training pass (JAX ``deterministic=False``, a generator on the
    port's side: train-mode BatchNorm where the model has it), JAX's
    ``bn_stats`` then kept in ``slice_["jax_bn_stats"]``."""
    jm, params, tm = slice_["jm"], slice_["params"], slice_["tm"]

    def jloss(p):
        ls = jm.apply({"params": p}, *slice_["args"], method=jm.losses,
                      deterministic=not train, mutable=["bn_stats"] if train else False,
                      rngs={"mask": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)})
        ls, stats = ls if train else (ls, {})
        return ls["total"], (ls, stats)

    jgrads, (jls, stats) = jax.jit(jax.grad(jloss, has_aux=True))(params)
    slice_["jax_bn_stats"] = stats.get("bn_stats", {})
    b = _t(slice_["batch"])
    tm.zero_grad(set_to_none=True)
    ls = tm.losses(b["img"], b["txt"], b["mask"], draws=slice_["draws"],
                   neg_idx=slice_["neg_idx"],
                   generator=torch.Generator().manual_seed(0) if train else None)
    ls["total"].backward()
    no_grad = {n for n, p in tm.named_parameters() if p.grad is None}
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).clone()
           for n, p in tm.named_parameters()}
    tm.zero_grad(set_to_none=True)
    return ls, jls, got, convert.state_dict_from_flax(_np_tree(jgrads), tm.config, heads), \
        no_grad


@pytest.fixture(scope="module")
def grads(slice_):
    """Losses and parameter gradients of both sides at the carried params
    (dropout off): JAX's as port-named tensors."""
    return losses_and_grads(slice_)


def test_losses_and_gradients_match_jax(grads):
    ls, jls, got, want, _ = grads
    assert set(ls) == {"mtm", "vtm", "mvm_pixel", "total"} == set(jls)
    for k in ls:
        np.testing.assert_allclose(ls[k].item(), float(jls[k]), err_msg=k, **LOSS_TOL)
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)


def test_optimizer_groups_match_jax_on_the_pretrain_tree(slice_):
    """The port's group of every parameter is the JAX ``default_group_fn``
    label of the leaf that ``state_dict_from_flax`` maps onto it."""
    tm = slice_["tm"]
    codes = jax.tree_util.tree_map_with_path(
        lambda path, x: np.full(np.shape(x), topt.GROUPS.index(
            jopt.default_group_fn(tuple(k.key for k in path))), np.float32),
        slice_["params"])
    want = convert.state_dict_from_flax(codes, tm.config, HEADS)
    labels = topt.group_labels(tm)
    for name, code in want.items():
        assert (code == topt.GROUPS.index(labels[name])).all(), name
    assert {labels[n] for n in labels} == set(topt.GROUPS)


def test_two_train_steps_match_make_pretrain_train_step(slice_, grads):
    """Step 0 runs at lr(0) = min_lr, step 1 at the full lr = 1e-3.

    Adam divides each gradient by its own running magnitude, so an element
    whose gradient is at the level of the two sides' fp32 roundoff moves by
    about +-lr on either side, whatever that roundoff is: the key biases and
    the score head's output bias, whose exact gradients are zero (the
    softmax and the VTM cross entropy are shift-invariant), and a few
    near-cancelling others. Elements whose gradient is resolved (|g| above
    100x the two sides' gradient difference and 1e-6) are held to 2e-6
    after the two updates; the rest to Adam's bound of 2 lr + 2e-6."""
    assert_two_steps_match(slice_, grads, HEADS)


def assert_two_steps_match(slice_, grads, heads, outliers=0.0, weight_decay=1e-3):
    """Two steps of the JAX ``make_pretrain_train_step`` and of the port's
    from the same carried params, held as the test above says; at most
    ``outliers`` of the resolved elements may exceed 2e-6 (within Adam's
    bound all the same). Returns both sides' state_dicts after the steps
    (JAX's in port names)."""
    jm, params = slice_["jm"], slice_["params"]
    tm = copy.deepcopy(slice_["tm"])
    _, _, got_g, want_g = grads[:4]
    tx = jopt.build_optimizer(params, lr=1e-3, max_iter=10, weight_decay=weight_decay)
    jstep = jts.make_pretrain_train_step(jm, tx, mesh=None, donate=False)
    jstate = jts.create_train_state(params, tx)
    jbatch = {k: jnp.asarray(v) for k, v in slice_["batch"].items()}
    opt = topt.AdamW(tm, 1e-3, 10, weight_decay=weight_decay)
    state = create_train_state(tm, opt)
    step = make_pretrain_train_step(tm, opt)
    batch = dict(_t(slice_["batch"]), draws=slice_["draws"], neg_idx=slice_["neg_idx"])
    for _ in range(2):
        jstate, jls = jstep(jstate, jbatch, jax.random.PRNGKey(7))
        state, ls = step(state, batch, 7)
        np.testing.assert_allclose(ls["total"].item(), float(jls["total"]), **LOSS_TOL)
    assert state.step == 2 and opt.schedules["other_decay"](1) == 1e-3
    want = convert.state_dict_from_flax(_np_tree(jstate.params), tm.config, heads)
    resolved_n, over = 0, []
    for name, p in tm.named_parameters():
        g = want_g[name].abs()
        resolved = (g > 100 * (got_g[name] - want_g[name]).abs()) & (g > 1e-6)
        resolved_n += int(resolved.sum())
        d = (p.detach() - want[name]).abs()
        if _max(d[resolved]) > 2e-6:
            over.append((name, int((d[resolved] > 2e-6).sum()), _max(d[resolved])))
        assert _max(d) <= 2e-3 + 2e-6, (name, _max(d))
    assert sum(n for _, n, _ in over) <= outliers * resolved_n, over
    assert resolved_n > 0.99 * sum(p.numel() for p in tm.parameters() if p.requires_grad
                                   ) - sum(int((want_g[n] == 0).sum()) for n in want_g
                                           if n in got_g)
    return tm.state_dict(), want


def test_pretrain_config_builds_the_slice():
    """configs/pretrain.json names the pixel slice; its model, cut to tiny
    widths, builds with the file's pretrain settings."""
    run = tcfg.load_run_config("configs/pretrain.json")
    assert run.train.mvm_target == ("pixel",) and run.train.size_batch == 20
    tiny = dataclasses.replace(run, model=dataclasses.replace(
        _model_cfg(tcfg), size_img=run.model.size_img // 7 * 2))
    m = VioletPretrain.from_run_config(tiny, device="cpu")
    assert (m.temp, m.p_mask, set(m.pretrain_masks)) == (0.05, 0.15, {"rm", "bm"})
    smtm = VioletPretrain(_model_cfg(tcfg), pretrain_tasks=("mtm", "smtm"), device="cpu")
    assert smtm.pretrain_tasks == ("mtm", "smtm")
    with pytest.raises(ValueError, match="pretrain_tasks"):
        VioletPretrain(_model_cfg(tcfg), pretrain_tasks=("mtm", "itm"), device="cpu")
