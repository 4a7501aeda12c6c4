"""The port's QA heads against the JAX package at tiny widths on the CPU,
fp32, inputs from numpy with a seed: ``VioletQAOE`` (the answer-vocabulary
head), ``VioletQAOEMLMHead`` with no prefix, a task token and a prompt,
``VioletQAMCGen``, ``VioletQAMCMLMHead``, ``VioletQAMC``'s gumbel
video-token selection, two ``mlm`` steps, the weight carry of every
``heads`` map the JAX CLIs pass, and the QA metrics.

The models are ``tests/test_torch_qamc.py``'s: a Video Swin at embed 32,
depths 1/1/1/1, a 2-layer BERT of hidden 32 (both packages route its
attention to the tiled self-attention), 2 frames of 64^2, every dropout and
drop-path rate 0 (the JAX ScoreHead's fixed 0.1 replaced inside the
fixture). Each model's parameters are drawn by the port, moved off their
init by 0.05 N(0, 1) and carried to JAX by the JAX importer
(``violet_params_from_torch``; ``emb_task``, which it lacks, directly), so
no JAX ``init`` is compiled; ``test_weight_carry_round_trip_of_every_heads_map``
holds that tree's structure to ``jax.eval_shape`` of the JAX ``init``.
"""

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
from empirical_mvm_tpu.models import encoders2d as jenc
from empirical_mvm_tpu.models import tasks as jtasks
from empirical_mvm_tpu.models import violet as jviolet
from empirical_mvm_tpu.models.torch_import import violet_params_from_torch
from empirical_mvm_tpu.train import evaluators as jeval
from empirical_mvm_tpu.train import losses as jlosses
from empirical_mvm_tpu.train import optimizer as jopt
from empirical_mvm_torch.core import config as tcfg
from empirical_mvm_torch.models import convert
from empirical_mvm_torch.models import tasks as ttasks
from empirical_mvm_torch.train import evaluators as teval
from empirical_mvm_torch.train import losses as tlosses
from empirical_mvm_torch.train import optimizer as topt
from empirical_mvm_torch.train.train_step import (create_train_state, make_eval_step,
                                                  make_supervised_train_step)

BERT = dict(vocab_size=200, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
SWIN = dict(embed_dim=32, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), drop_path_rate=0.0)
B, O, X = 2, 3, 8
SIZE_VOCAB = 7                 # the QA-OE answer vocabulary
MASK_ID, TRUE_ID, FALSE_ID = 103, 150, 151
DIGITS = (160, 161, 162)       # the generative MC's answer tokens "0", "1", "2"
PROMPT = np.array([101, 120, 121, 122, 102], np.int32)    # [CLS] p p p [SEP]
NUM_VIDEO_TOKENS = 4
FWD_TOL = dict(atol=2e-5, rtol=1e-4)
LOSS_TOL = dict(atol=1e-5, rtol=1e-4)
GRAD_TOL = dict(atol=2e-4, rtol=1e-3)  # fp32 summation order through the model
LR, MAX_ITER = 1e-3, 10
# the heads map that JAX cli/qa.py (and cli/retrieval.py) passes for each model
SCORE = {"fc": "score_head"}
MLM = {"fc_mtm": "mlm_head"}
GUMBEL = {"fc": "score_head", "vid_key": "linear", "vid_query": "linear"}


def model_cfg(c, **kw):
    return c.ModelConfig(size_img=64, size_frame=2, size_txt=X, size_option=O,
                         size_vocab=SIZE_VOCAB, fusion=c.BertConfig(**BERT),
                         text=c.BertConfig(**BERT), swin_custom=c.SwinConfig(**SWIN), **kw)


def _text(rs, rows, x=X):
    """[CLS] tokens [SEP] rows of 4 to x tokens, zero-padded, and their mask."""
    txt = np.zeros((rows, x), np.int32)
    for row in txt:
        n = rs.randint(4, x + 1)
        row[:n] = rs.randint(104, 140, n)
        row[0], row[n - 1] = 101, 102
    return txt, (txt > 0).astype(np.int32)


def _with_mask_slot(txt, rows_without=()):
    """[MASK] before each row's [SEP] (none in ``rows_without``); returns the
    slot of each row (-1 for none)."""
    slots = []
    for i, row in enumerate(txt):
        if i in rows_without:
            slots.append(-1)
            continue
        slots.append(int(np.where(row == 102)[0][0]) - 1)
        row[slots[-1]] = MASK_ID
    return np.array(slots)


def clips(rs, b=B):
    return rs.randint(0, 256, (b, 2, 64, 64, 3)).astype(np.uint8)


def qa_batch(kind, seed=0):
    """A seeded batch for each kind of model: ``oe`` (txt (B, X), ans into
    the answer vocabulary), ``oe_mlm`` and ``gen`` (txt (B, X) with [MASK]
    and ``mask_ans``: the answer id there, -1 elsewhere), ``mc_mlm`` (txt
    (B, O, X), "true" or "false" at each option's [MASK]) and ``mc`` (txt
    (B, O, X), ans (B,))."""
    rs = np.random.RandomState(seed)
    out = {"img": clips(rs)}
    if kind in ("mc", "mc_mlm"):
        txt, mask = _text(rs, B * O)
        txt, mask = txt.reshape(B, O, X), mask.reshape(B, O, X)
    else:
        txt, mask = _text(rs, B)
    out.update(txt=txt, mask=mask)
    if kind == "oe":
        out["ans"] = rs.randint(0, SIZE_VOCAB, B).astype(np.int32)
    elif kind == "mc":
        out["ans"] = np.array([2, 0], np.int32)
    elif kind in ("oe_mlm", "gen"):
        slots = _with_mask_slot(txt)
        ans = rs.randint(104, 200, B) if kind == "oe_mlm" else np.array(DIGITS)[[1, 2]]
        out["mask_ans"] = np.where(np.arange(X)[None] == slots[:, None], ans[:, None],
                                   -1).astype(np.int32)
        out["ans_idx"] = np.array([1, 2], np.int32)
    else:
        flat = txt.reshape(B * O, X)
        slots = _with_mask_slot(flat)
        truth = np.array([[0, 0, 1], [1, 0, 0]]).reshape(-1)
        ans = np.where(truth == 1, TRUE_ID, FALSE_ID)
        out["mask_ans"] = np.where(np.arange(X)[None] == slots[:, None], ans[:, None],
                                   -1).astype(np.int32).reshape(B, O, X)
    return out


def t_(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def carry(tm, jcfg_model, heads, seed=1):
    """The port model's parameters moved off their init by 0.05 N(0, 1)
    (loaded back into it) and the same values as a JAX tree: the JAX
    importer's, with ``emb_task`` added."""
    rs = np.random.RandomState(seed)
    sd = {k: (v.numpy() + 0.05 * rs.randn(*v.shape)).astype(np.float32)
          for k, v in tm.state_dict().items()}
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    tree = violet_params_from_torch(sd, jcfg_model, heads=heads)
    if "emb_task" in sd:
        tree["emb_task"] = sd["emb_task"]
    return tree


def no_score_dropout(tm):
    if hasattr(tm, "fc"):
        tm.fc[0].p = 0.0
    return tm


@pytest.fixture(scope="module")
def jax_scorehead():
    """The JAX ScoreHead's dropout at 0 while the module's tests run (flax
    builds the heads at apply time)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtasks, "ScoreHead", functools.partial(jviolet.ScoreHead, dropout=0.0))
        yield


# each model: (port class, JAX class, heads map, config switches, port and
# JAX keyword arguments, batch kind)
MODELS = {
    "qaoe": (ttasks.VioletQAOE, jtasks.VioletQAOE, SCORE, {}, {},
             {"size_vocab": SIZE_VOCAB}, "oe"),
    "qaoe_mlm": (ttasks.VioletQAOEMLMHead, jtasks.VioletQAOEMLMHead, MLM, {}, {}, {},
                 "oe_mlm"),
    "qaoe_mlm_task_token": (ttasks.VioletQAOEMLMHead, jtasks.VioletQAOEMLMHead, MLM,
                            {"enable_task_token": True, "task_token": "oe"}, {}, {},
                            "oe_mlm"),
    "qaoe_mlm_prompt": (ttasks.VioletQAOEMLMHead, jtasks.VioletQAOEMLMHead, MLM,
                        {"enable_prompt": True},
                        {"prompt_tokens": tuple(int(i) for i in PROMPT)},
                        {"prompt_tokens": tuple(int(i) for i in PROMPT),
                         "prompt_mask_static": (1,) * len(PROMPT)}, "oe_mlm"),
    "qamc_gen": (ttasks.VioletQAMCGen, jtasks.VioletQAMCGen, MLM, {}, {}, {}, "gen"),
    "qamc_mlm": (ttasks.VioletQAMCMLMHead, jtasks.VioletQAMCMLMHead, MLM, {}, {}, {},
                 "mc_mlm"),
    "qamc_gumbel": (ttasks.VioletQAMC, jtasks.VioletQAMC, GUMBEL, {},
                    {"num_video_tokens": NUM_VIDEO_TOKENS},
                    {"num_video_tokens": NUM_VIDEO_TOKENS}, "mc"),
}


def build(name, seed=2):
    """(JAX model, its params, port model carrying them, batch, JAX args)."""
    tcls, jcls, heads, switches, tkw, jkw, kind = MODELS[name]
    tm = no_score_dropout(tcls(model_cfg(tcfg, **switches), device="cpu", seed=seed, **tkw))
    jm = jcls(config=model_cfg(jcfg, **switches), **jkw)
    params = carry(tm, jm.config, heads)
    batch = qa_batch(kind)
    return jm, params, tm, batch, [jnp.asarray(batch[k]) for k in ("img", "txt", "mask")]


@pytest.fixture(scope="module")
def built(jax_scorehead):
    return {name: build(name) for name in MODELS}


def jax_forward(jm, params, args, **kw):
    return np.asarray(jax.jit(lambda p, *a: jm.apply({"params": p}, *a, **kw))(params, *args))


@pytest.mark.parametrize("name", [n for n in MODELS if n != "qamc_gumbel"])
def test_forward_matches_jax(built, name):
    """The eval forward (``make_eval_step``) of each QA model against the
    JAX model's: logits (B, size_vocab), (B, X, V) or (B, O, X, V)."""
    jm, params, tm, batch, args = built[name]
    want = jax_forward(jm, params, args)
    got = make_eval_step(tm)(t_(batch))
    shapes = {"qaoe": (B, SIZE_VOCAB), "qamc_mlm": (B, O, X, BERT["vocab_size"])}
    assert got.shape == shapes.get(name, (B, X, BERT["vocab_size"])) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


def test_qaoe_mlm_prefixes_shift_the_fused_text(built):
    """The prefixes change the output: a task token, the static prompt (P,),
    and a per-call prompt (B, P) given to both packages, whose rows differ;
    the per-call prompt equal to the static one repeated gives the static
    one's logits."""
    plain = make_eval_step(built["qaoe_mlm"][2])(t_(built["qaoe_mlm"][3]))
    for name in ("qaoe_mlm_task_token", "qaoe_mlm_prompt"):
        tm, batch = built[name][2], built[name][3]
        tm_plain = built["qaoe_mlm"][2]
        assert (make_eval_step(tm)(t_(batch)) - plain).abs().max() > 1e-3, name
        assert set(tm.state_dict()) - set(tm_plain.state_dict()) == (
            {"emb_task"} if name.endswith("token") else set())
    jm, params, tm, batch, args = built["qaoe_mlm_prompt"]
    rs = np.random.RandomState(5)
    p_txt, p_mask = _text(rs, B, 6)
    want = jax_forward(jm, params, args, prompt=(jnp.asarray(p_txt), jnp.asarray(p_mask)))
    with torch.no_grad():
        got = tm(*(t_(batch)[k] for k in ("img", "txt", "mask")),
                 prompt=(torch.from_numpy(p_txt), torch.from_numpy(p_mask)))
        static = tm(*(t_(batch)[k] for k in ("img", "txt", "mask")),
                    prompt=(torch.from_numpy(np.tile(PROMPT, (B, 1))),
                            torch.ones(B, len(PROMPT), dtype=torch.int32)))
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    np.testing.assert_allclose(static.numpy(), make_eval_step(tm)(t_(batch)).numpy(),
                               atol=1e-6, rtol=0)


def test_prepend_pretxt_matches_jax(built):
    """``prepend_pretxt`` alone: the task token's row and the encoded prompt
    prepended to the text features and mask, and the prefix length, against
    the JAX method (its label row: the prefix's -1 then the labels)."""
    for name, prompt in (("qaoe_mlm_task_token", None),
                         ("qaoe_mlm_prompt", (PROMPT, np.ones(len(PROMPT), np.int32))),
                         ("qaoe_mlm", None)):
        jm, params, tm, batch, _ = built[name]
        rs = np.random.RandomState(3)
        feat = rs.randn(B, X, 32).astype(np.float32)
        ans = rs.randint(0, 9, (B, X)).astype(np.int32)
        jprompt = None if prompt is None else tuple(jnp.asarray(p) for p in prompt)
        j_ans, j_mask, j_feat, j_pre = jm.apply(
            {"params": params}, jnp.asarray(ans), jnp.asarray(batch["mask"]),
            jnp.asarray(feat), prompt=jprompt, method=jm.prepend_pretxt)
        tprompt = None if prompt is None else tuple(torch.from_numpy(p) for p in prompt)
        with torch.no_grad():
            mask, got, pre = tm.prepend_pretxt(torch.from_numpy(batch["mask"]),
                                               torch.from_numpy(feat), tprompt)
        assert pre == j_pre == {"qaoe_mlm": 0, "qaoe_mlm_task_token": 1}.get(name, len(PROMPT))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(j_feat), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(np.asarray(j_ans)[:, pre:], ans)


def _jax_gumbel(monkeypatch, noise):
    """Replace ``jax.random.gumbel`` by the port's noise for one test."""

    def fake(key, shape, dtype=jnp.float32):
        assert tuple(shape) == noise.shape
        return jnp.asarray(noise)

    monkeypatch.setattr(jax.random, "gumbel", fake)


def test_gumbel_selection_matches_jax_with_injected_noise_and_none(built, monkeypatch):
    """``select_vid_token`` and the training forward with the same Gumbel
    noise on both sides (``jax.random.gumbel`` returning the port's draws),
    and the eval (noise 0): the kept-token masks are equal, the noise keeps
    other tokens than the eval does, and the logits agree."""
    jm, params, tm, batch, args = built["qamc_gumbel"]
    gen = torch.Generator().manual_seed(4)
    feat = torch.from_numpy(np.random.RandomState(6).randn(B, 10, 32).astype(np.float32))
    mask = torch.ones(B, 10, dtype=torch.int32)
    mask[1, 7:] = 0
    noise = ttasks.draw_gumbel((B, NUM_VIDEO_TOKENS, 10), gen)
    _jax_gumbel(monkeypatch, noise.numpy())
    keys = {"dropout": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1)}
    masks = {}
    for label, det, tnoise in (("noise", False, noise), ("eval", True, None)):
        want = np.asarray(jm.apply({"params": params}, jnp.asarray(feat.numpy()),
                                   jnp.asarray(mask.numpy()), deterministic=det,
                                   method=jm.select_vid_token, rngs=keys))
        with torch.no_grad():
            got = tm.select_vid_token(feat, mask, noise=tnoise)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=label)
        assert got.dtype == torch.int32 and 1 <= got.sum(1).min() and got.sum(1).max() <= 4
        assert not got[1, 7:].any()
        masks[label] = got
    assert not torch.equal(masks["noise"], masks["eval"])
    with torch.no_grad():
        assert torch.equal(tm.select_vid_token(feat, mask, generator=torch.Generator()
                                               .manual_seed(4)), masks["noise"])
    noise = ttasks.draw_gumbel((B, NUM_VIDEO_TOKENS, 10), gen)
    _jax_gumbel(monkeypatch, noise.numpy())
    want = jax_forward(jm, params, args, deterministic=False, rngs=keys)
    with torch.no_grad():
        got = tm(*(t_(batch)[k] for k in ("img", "txt", "mask")), generator=gen,
                 gumbel_noise=noise)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    np.testing.assert_allclose(make_eval_step(tm)(t_(batch)).numpy(),
                               jax_forward(jm, params, args), **FWD_TOL)


def jax_tx(params, train):
    return jopt.build_optimizer(params, lr=train.lr, max_iter=MAX_ITER,
                                weight_decay=train.decay, betas=train.betas,
                                warmup_ratio=train.warmup_ratio, min_lr=train.min_lr,
                                max_grad_norm=train.max_grad_norm,
                                backbone_lr_mul=train.vis_backbone_lr_mul,
                                freeze_prefixes=tuple(train.freeze))


def jax_agent_step(jm, tx, batch, loss_fn, rngs=None):
    """One step of the JAX ``make_supervised_agent`` from its pieces:
    ``value_and_grad`` of ``loss_fn(out, batch)`` over the training pass
    (the agent's ``dropout`` key, and ``rngs`` besides), then the optax
    update, then train-mode BatchNorm statistics folded in
    (``fold_bn_stats``, where the model sows any). Returns (params,
    opt_state, loss, grads)."""
    img, txt, mask = (jnp.asarray(batch[k]) for k in ("img", "txt", "mask"))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def step(params, opt_state):
        def loss(p):
            out, mut = jm.apply({"params": p}, img, txt, mask, deterministic=False,
                                rngs={"dropout": jax.random.PRNGKey(7), **(rngs or {})},
                                mutable=["bn_stats"])
            return loss_fn(out, jbatch), mut.get("bn_stats", {})

        (value, bn_stats), grads = jax.value_and_grad(loss, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jenc.fold_bn_stats(optax.apply_updates(params, updates), bn_stats)
        return params, opt_state, value, grads

    return jax.jit(step)


def two_steps_match_jax(jm, params, tm, batch, loss_kind, loss_fn, heads, temp=0.05,
                        rngs=None, decay=None, out=None, grads_match=None, outliers=1e-4):
    """Two ``make_supervised_train_step(loss_kind)`` steps of ``tm`` against
    the JAX agent's step at rates 0, as ``test_two_ce_steps_match_the_jax_qamc_step``
    holds them: step 0 at lr(0) = min_lr, step 1 at lr = 1e-3; each loss at
    rtol 1e-4, step 0's gradients at atol 2e-4 / rtol 1e-3; the parameters
    after each step: elements whose gradient is resolved within 2e-6 (at
    most 1e-4 of them beyond), the rest within Adam's bound of 2 lr + 2e-6.
    ``decay`` replaces the run's weight decay on both sides; ``out``, a
    dict, receives the JAX parameters after the steps (``jax_params``);
    ``grads_match(got, want)`` replaces the step-0 gradients' check, and
    ``outliers`` the share of resolved elements allowed beyond 2e-6.
    Returns the port's parameters without a gradient."""
    raw = {"lr": LR, "temp": temp, **({} if decay is None else {"decay": decay})}
    jrun, trun = jcfg.load_run_config(raw), tcfg.load_run_config(raw)
    tx = jax_tx(params, jrun.train)
    jstep = jax_agent_step(jm, tx, {k: v for k, v in batch.items() if k != "gumbel_noise"},
                           loss_fn, rngs)
    opt = topt.build_optimizer(tm, trun.train, MAX_ITER)
    state = create_train_state(tm, opt)
    step = make_supervised_train_step(tm, opt, loss_kind, trun.train.temp)
    tb = t_(batch)
    jparams, jopt_state = params, tx.init(params)
    for i in range(2):
        jparams, jopt_state, jloss, jgrads = jstep(jparams, jopt_state)
        state, ls = step(state, tb, 7)
        np.testing.assert_allclose(ls["total"].item(), float(jloss), **LOSS_TOL)
        want_g = convert.state_dict_from_flax(jax.tree.map(np.asarray, jgrads), tm.config, heads)
        got_g = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in tm.named_parameters()}
        if i == 0:
            grads0 = (got_g, want_g)
            if grads_match is not None:
                grads_match(got_g, want_g)
            for name, g in got_g.items():
                if grads_match is None:
                    np.testing.assert_allclose(g.numpy(), want_g[name].numpy(), err_msg=name,
                                               **GRAD_TOL)
        want = convert.state_dict_from_flax(jax.tree.map(np.asarray, jparams), tm.config, heads)
        resolved_n, over = 0, []
        for name, p in tm.named_parameters():
            g0, w0 = grads0[0][name], grads0[1][name].abs()
            resolved = (w0 > 100 * (g0 - grads0[1][name]).abs()) & (w0 > 1e-6)
            resolved_n += int(resolved.sum())
            d = (p.detach() - want[name]).abs()
            assert d.max().item() <= 2 * LR + 2e-6, (i, name)
            if resolved.any() and d[resolved].max().item() > 2e-6:
                over.append((name, int((d[resolved] > 2e-6).sum()), d[resolved].max().item()))
        assert sum(n for _, n, _ in over) <= outliers * resolved_n, (i, over)
    assert state.step == 2
    if out is not None:
        out["jax_params"] = jparams
    return {n for n, p in tm.named_parameters() if p.grad is None}


def _mlm_loss(out, batch):
    return jlosses.cross_entropy_ignore(out, batch["mask_ans"])


def test_two_mlm_steps_match_the_jax_agent_step(jax_scorehead):
    """The ``mlm`` step (``QAOEMLMAgent``: the MLM logits against
    ``mask_ans``) of the open-ended head with its task token, whose
    ``emb_task`` trains: two steps against JAX."""
    jm, params, tm, batch, _ = build("qaoe_mlm_task_token", seed=3)
    no_grad = two_steps_match_jax(jm, params, tm, batch, "mlm", _mlm_loss, MLM)
    assert no_grad == {"enc_img.emb_odr"}


def test_gumbel_ce_step_matches_jax_with_injected_noise(jax_scorehead, monkeypatch):
    """Two ``ce`` steps of ``VioletQAMC(num_video_tokens=4)``, the batch's
    ``gumbel_noise`` on the port's side and ``jax.random.gumbel`` returning
    it on the JAX side: the selection masks the fusion, and its projections
    get no gradient on either side (the kept-token mask is a comparison, as
    in JAX)."""
    jm, params, tm, batch, _ = build("qamc_gumbel", seed=3)
    noise = ttasks.draw_gumbel((B, NUM_VIDEO_TOKENS, 10), torch.Generator().manual_seed(8))
    _jax_gumbel(monkeypatch, noise.numpy())
    batch = {**batch, "gumbel_noise": noise.numpy()}
    no_grad = two_steps_match_jax(jm, params, tm, batch, "ce",
                                  lambda out, b: jlosses.cross_entropy_ignore(out, b["ans"]),
                                  GUMBEL, rngs={"gumbel": jax.random.PRNGKey(2)})
    assert no_grad == {"enc_img.emb_odr", "vid_key.weight", "vid_query.weight"}


def test_supervised_step_refuses_an_unknown_loss(built):
    tm = built["qaoe"][2]
    with pytest.raises(ValueError, match="loss_kind"):
        make_supervised_train_step(tm, topt.build_optimizer(
            tm, tcfg.load_run_config({}).train, MAX_ITER), "smtm")


@pytest.mark.parametrize("name", ["qaoe", "qaoe_mlm_task_token", "qamc_mlm", "qamc_gumbel"])
def test_weight_carry_round_trip_of_every_heads_map(built, name):
    """Each model's state_dict through the JAX importer with its CLI's
    ``heads`` map and back through ``state_dict_from_flax`` is unchanged
    leaf for leaf; the tree has the leaves and shapes of the JAX ``init``
    (``jax.eval_shape``), ``emb_task`` included."""
    jm, params, tm, batch, args = built[name]
    heads = MODELS[name][2]
    sd = convert.state_dict_from_flax(params, tm.config, heads)
    assert set(sd) == set(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert torch.equal(sd[k], v), k
    want = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))["params"]
    got = jax.tree.map(np.shape, params)
    assert jax.tree.map(lambda s: tuple(s.shape), want) == got


def test_emb_task_leaf_is_carried(built):
    """``emb_task``, which the JAX importer does not read, lands in the
    port's ``emb_task`` unchanged, and the port's prefix is its task's row."""
    jm, params, tm, batch, _ = built["qaoe_mlm_task_token"]
    sd = convert.state_dict_from_flax(params, tm.config, MLM)
    np.testing.assert_array_equal(sd["emb_task"].numpy(), np.asarray(params["emb_task"]))
    assert sd["emb_task"].shape == (tm.config.num_task_tokens, 32)
    with torch.no_grad():
        _, feat, _ = tm.prepend_pretxt(torch.ones(1, 2, dtype=torch.int32), torch.zeros(1, 2, 32))
    assert torch.equal(feat[0, 0], tm.emb_task[tm.TASK_TOK2ID["oe"]].detach())


@pytest.mark.parametrize("rows,tokens,lane", [
    (64, 275, True),       # retrieval fine-tuning: 8 x 8 pairs, 25-token captions
    (10, 276, True),       # open-ended QA with the task token
    (10, 286, True),       # ... with an 11-token prompt
    (8, 350, False),       # generative multiple choice (tgif-action)
    (40, 350, False),      # MLM-head and gumbel multiple choice
    (8, 275, True),        # the caption step: 8 clips of 5 frames, 25 caption tokens
    (8, 270, True),        # greedy caption decoding at max_len 20
    (32, 270, True),       # beam search, 4 beams
    (20, 232, True),       # the smtm fusion of the pretrain step
])
def test_fusion_route_at_the_heads_lengths_matches_jax(rows, tokens, lane):
    """BERT-base's route at each new step's fusion length, prefixes
    included: the port's ``lane_sa_attention_fits`` and the JAX rule agree."""
    from empirical_mvm_tpu.ops import window_attention as jwa
    from empirical_mvm_torch.ops import window_attention as twa
    assert twa.lane_sa_attention_fits(rows, tokens, 768, 12) is lane
    assert bool(jwa.lane_sa_attention_fits(rows, tokens, 768, 12)) is lane


def test_qa_models_default_to_the_card():
    """Every new model is built on the card unless the caller asks for the
    CPU (here there is none, so the default fails where CUDA is missing)."""
    import inspect
    from empirical_mvm_torch.models.captioning import VioletCaptioning
    for cls in (ttasks.VioletQAOE, ttasks.VioletQAOEMLMHead, ttasks.VioletQAMCGen,
                ttasks.VioletQAMCMLMHead, ttasks.VioletQAMC, ttasks.VioletRetrieval,
                VioletCaptioning):
        assert inspect.signature(cls).parameters["device"].default == "cuda", cls


# --- the metrics, on seeded arrays --------------------------------------------

def test_masked_accuracy_matches_jax():
    rs = np.random.RandomState(9)
    labels = rs.randint(-1, 4, (6, 7)).astype(np.int32)
    pred = rs.randint(0, 4, (6, 7)).astype(np.int32)
    for lab in (labels, np.full_like(labels, -1)):
        want = float(jlosses.masked_accuracy(jnp.asarray(pred), jnp.asarray(lab)))
        got = tlosses.masked_accuracy(torch.from_numpy(pred), torch.from_numpy(lab))
        assert got.item() == pytest.approx(want, abs=1e-7)
    assert tlosses.masked_accuracy(torch.from_numpy(pred), torch.full((6, 7), -1)).item() == 0.0


def test_qamc_gen_accuracy_matches_jax():
    """Rows with [MASK] (the argmax over the digit tokens against ans_idx)
    and a row without, which counts 0."""
    rs = np.random.RandomState(10)
    logits = rs.randn(5, X, 200).astype(np.float32)
    txt = rs.randint(104, 140, (5, X)).astype(np.int32)
    txt[np.arange(4), rs.randint(0, X, 4)] = MASK_ID
    ans = rs.randint(0, 3, 5)
    for a in (ans, logits[np.arange(5), np.argmax(txt == MASK_ID, 1)][:, list(DIGITS)]
              .argmax(1)):
        got = teval.qamc_gen_accuracy(logits, txt, MASK_ID, DIGITS, a)
        assert got == jeval.qamc_gen_accuracy(logits, txt, MASK_ID, DIGITS, a)
    assert got == [1.0, 1.0, 1.0, 1.0, 0.0]


@pytest.mark.parametrize("k", [1, 5])
def test_qaoe_mlm_topk_matches_jax(k):
    """Top-k at the first answer position, a row without an answer counting
    0; the answer set at each row's k-th largest logit is in, the one just
    below it out."""
    rs = np.random.RandomState(11)
    logits = rs.randn(6, X, 200).astype(np.float32)
    mask_ans = np.full((6, X), -1, np.int32)
    pos = rs.randint(0, X, 5)
    order = np.argsort(-logits[np.arange(5), pos], axis=1)
    mask_ans[np.arange(5), pos] = np.where(np.arange(5) % 2 == 0, order[:, k - 1], order[:, k])
    got = teval.qaoe_mlm_topk(logits, mask_ans, k)
    assert got == jeval.qaoe_mlm_topk(logits, mask_ans, k) == [1.0, 0.0, 1.0, 0.0, 1.0, 0.0]
    rand = np.where(mask_ans >= 0, rs.randint(0, 200, mask_ans.shape), -1)
    assert teval.qaoe_mlm_topk(logits, rand, k) == jeval.qaoe_mlm_topk(logits, rand, k)


def test_qamc_mlm_head_accuracy_matches_jax():
    """The raw-logit ratio p_true / (p_true + p_false + 1e-9) per option, an
    option without a slot at -inf, a question without a true option 0."""
    rs = np.random.RandomState(12)
    logits = rs.randn(4, O, X, 200).astype(np.float32)
    mask_ans = np.full((4, O, X), -1, np.int32)
    for i in range(4):
        for j in range(O):
            if (i, j) != (2, 1):
                mask_ans[i, j, rs.randint(X)] = TRUE_ID if j == i % O else FALSE_ID
    mask_ans[3] = np.where(mask_ans[3] >= 0, FALSE_ID, -1)
    got = ttasks.qamc_mlm_head_accuracy(logits, mask_ans, TRUE_ID, FALSE_ID)
    assert got == jtasks.qamc_mlm_head_accuracy(logits, mask_ans, TRUE_ID, FALSE_ID)
    assert got[3] == 0.0 and len(got) == 4
    sure = logits.copy()
    for i, j in np.argwhere((mask_ans >= 0).any(-1)):
        slot = np.where(mask_ans[i, j] >= 0)[0][0]
        sure[i, j, slot, [TRUE_ID, FALSE_ID]] = [5.0, 1.0] if j == i % O else [1.0, 5.0]
    assert ttasks.qamc_mlm_head_accuracy(sure, mask_ans, TRUE_ID, FALSE_ID) == [1.0] * 3 + [0.0]


def test_qa_accuracies_of_both_packages_on_the_models(built):
    """The metrics over both packages' eval logits of the tiny models: equal
    values (the logits agree to 2e-5, no tie that close here)."""
    jm, params, tm, batch, args = built["qamc_gen"]
    want = jax_forward(jm, params, args)
    got = make_eval_step(tm)(t_(batch)).numpy()
    assert (teval.qamc_gen_accuracy(got, batch["txt"], MASK_ID, DIGITS, batch["ans_idx"])
            == jeval.qamc_gen_accuracy(want, batch["txt"], MASK_ID, DIGITS, batch["ans_idx"]))
    jm, params, tm, batch, args = built["qaoe_mlm"]
    want = jax_forward(jm, params, args)
    got = make_eval_step(tm)(t_(batch)).numpy()
    for k in (1, 5):
        assert (teval.qaoe_mlm_topk(got, batch["mask_ans"], k)
                == jeval.qaoe_mlm_topk(want, batch["mask_ans"], k))
    jm, params, tm, batch, args = built["qamc_mlm"]
    want = jax_forward(jm, params, args)
    got = make_eval_step(tm)(t_(batch)).numpy()
    assert (ttasks.qamc_mlm_head_accuracy(got, batch["mask_ans"], TRUE_ID, FALSE_ID)
            == jtasks.qamc_mlm_head_accuracy(want, batch["mask_ans"], TRUE_ID, FALSE_ID))
