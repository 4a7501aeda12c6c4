"""The port's captioning slice against the JAX package at tiny widths on the
CPU, fp32, inputs from numpy with a seed: the ``seq2seq`` joint mask, the
training logits and ``label_smoothed_nll``, two ``caption`` steps, the
greedy tokens of the re-encoding and the K/V-cached decoders, beam search,
the sampling filter, the caption metrics, the ``smtm`` pretrain loss, the
``fc_mtm`` weight carry and the capbench tool's functions.

The captioning model is ``tests/test_torch_qa_heads.py``'s trunk (a Video
Swin at embed 32, depths 1/1/1/1, a 2-layer BERT of hidden 32, 2 frames of
64^2: 10 video tokens, every dropout and drop-path rate 0) with an MLM
head; its parameters are drawn by the port, moved off their init by 0.05
N(0, 1) and carried to JAX by the JAX importer, so no JAX ``init``
compiles (``jax.eval_shape`` holds the tree). The JAX fusion runs its XLA
attention on the CPU, the port its kernels' plain versions.
"""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (pins JAX to the CPU)
from tests.torch_threads import torch_threads  # noqa: F401  (the cores' share under xdist)

import jax
import jax.numpy as jnp

from empirical_mvm_tpu.core import config as jcfg
from empirical_mvm_tpu.models import captioning as jcap
from empirical_mvm_tpu.models import violet as jviolet
from empirical_mvm_tpu.train import caption_metrics as jmetrics
from empirical_mvm_tpu.train import losses as jlosses
from empirical_mvm_torch.core import config as tcfg
from empirical_mvm_torch.models import captioning as tcap
from empirical_mvm_torch.models import convert
from empirical_mvm_torch.models import violet as tviolet
from empirical_mvm_torch.tools import capbench
from empirical_mvm_torch.train import caption_metrics as tmetrics
from empirical_mvm_torch.train import losses as tlosses
from tests.test_torch_pretrain import HEADS as PRETRAIN_HEADS
from tests.test_torch_pretrain import _model_cfg as pretrain_cfg
from tests.test_torch_pretrain import carried_slice, losses_and_grads
from tests.test_torch_qa_heads import (BERT, FWD_TOL, LOSS_TOL, GRAD_TOL, MLM, SWIN, _text,
                                       carry, clips, t_, two_steps_match_jax)

B, X = 2, 8
MAX_LEN = 6                    # the decoders' text tokens: 10 + 6 fusion rows
MASK_ID = 103


def model_cfg(c):
    return c.ModelConfig(size_img=64, size_frame=2, size_txt=X, fusion=c.BertConfig(**BERT),
                         text=c.BertConfig(**BERT), swin_custom=c.SwinConfig(**SWIN))


def caption_batch(seed=0):
    """Captions of 4 to X tokens, a third of the tokens between [CLS] and
    [SEP] replaced by [MASK] (at least one a row), ``mask_ans`` the original
    token there and -1 elsewhere (the JAX ``CaptionDataset`` corruption)."""
    rs = np.random.RandomState(seed)
    txt, mask = _text(rs, B)
    ans = np.full_like(txt, -1)
    for row, a, n in zip(txt, ans, mask.sum(1)):
        pick = np.zeros(X, bool)
        pick[1:n - 1] = rs.rand(n - 2) < 0.33
        pick[1 + rs.randint(n - 2)] = True
        a[pick], row[pick] = row[pick], MASK_ID
    return {"img": clips(rs), "txt": txt, "mask": mask, "mask_ans": ans}


@pytest.fixture(scope="module")
def built():
    """(JAX model, its params, port model carrying them, batch, JAX args)."""
    tm = tcap.VioletCaptioning(model_cfg(tcfg), device="cpu", seed=2)
    jm = jcap.VioletCaptioning(config=model_cfg(jcfg))
    params = carry(tm, jm.config, MLM)
    batch = caption_batch()
    return jm, params, tm, batch, [jnp.asarray(batch[k]) for k in ("img", "txt", "mask")]


def test_seq2seq_mask_matches_jax():
    """``joint_attn_bias`` against JAX, exactly, for both mask types, with
    invalid video tokens and padded text. Under seq2seq no row is wholly
    masked: every row sees each valid video key (the first here), video rows
    no text, text rows the text at or before them, the padding included
    (``mask_txt`` does not enter the seq2seq mask, as in JAX)."""
    rs = np.random.RandomState(0)
    lv, lt = 5, 4
    mask_img = rs.randint(0, 2, (3, lv)).astype(np.int32)
    mask_img[:, 0] = 1
    mask_txt = np.array([[1, 1, 1, 1], [1, 1, 0, 0], [1, 0, 0, 0]], np.int32)
    for kind in ("full", "seq2seq"):
        want = np.asarray(jviolet.joint_attn_bias(jnp.asarray(mask_img), jnp.asarray(mask_txt),
                                                  kind))
        got = tviolet.joint_attn_bias(torch.from_numpy(mask_img), torch.from_numpy(mask_txt),
                                      kind)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    allowed = got[:, 0].numpy() == 0                                 # (B, L, L)
    assert got.shape == (3, 1, lv + lt, lv + lt)
    np.testing.assert_array_equal(allowed[:, :, :lv],
                                  np.broadcast_to(mask_img[:, None] == 1, (3, lv + lt, lv)))
    assert not allowed[:, :lv, lv:].any()
    np.testing.assert_array_equal(allowed[:, lv:, lv:],
                                  np.broadcast_to(np.tril(np.ones((lt, lt))) == 1, (3, lt, lt)))
    assert allowed.any(-1).all()
    with pytest.raises(ValueError, match="attn_mask_type"):
        tviolet.joint_attn_bias(torch.from_numpy(mask_img), torch.from_numpy(mask_txt), "causal")


def test_training_logits_and_label_smoothed_nll_match_jax(built):
    """The training pass's logits (B, X, V) without dropout, and
    ``label_smoothed_nll`` of each side's logits, within 1e-5; the loss on
    the same logits in both packages, with labels all ignored too (the
    denominator is at least 1)."""
    jm, params, tm, batch, args = built
    want = np.asarray(jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(params, *args))
    with torch.no_grad():
        got = tm(*(t_(batch)[k] for k in ("img", "txt", "mask")))
    assert got.shape == (B, X, BERT["vocab_size"])
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    labels = batch["mask_ans"]
    jl = float(jlosses.label_smoothed_nll(jnp.asarray(want), jnp.asarray(labels)))
    tl = tlosses.label_smoothed_nll(got, torch.from_numpy(labels)).item()
    assert abs(tl - jl) <= 1e-5
    rs = np.random.RandomState(4)
    logits = (rs.randn(3, 7, 50) * 3).astype(np.float32)
    for lab in (rs.randint(-1, 50, (3, 7)), np.full((3, 7), -1)):
        for eps in (0.1, 0.0, 0.3):
            want_l = float(jlosses.label_smoothed_nll(jnp.asarray(logits), jnp.asarray(lab),
                                                      eps))
            got_l = tlosses.label_smoothed_nll(torch.from_numpy(logits), torch.from_numpy(lab),
                                               eps).item()
            assert got_l == pytest.approx(want_l, rel=1e-6, abs=1e-6)
    assert got_l == 0.0


def test_two_caption_steps_match_the_jax_agent_step():
    """Two ``make_supervised_train_step(loss_kind="caption")`` steps (the
    training pass, ``label_smoothed_nll`` against ``mask_ans``, AdamW)
    against the JAX ``CaptionAgent`` step's pieces, held as
    ``test_torch_qa_heads.two_steps_match_jax`` holds them (parameters
    within 2e-6 where resolved, all within Adam's 2 lr + 2e-6)."""
    tm = tcap.VioletCaptioning(model_cfg(tcfg), device="cpu", seed=3)
    jm = jcap.VioletCaptioning(config=model_cfg(jcfg))
    params = carry(tm, jm.config, MLM)
    no_grad = two_steps_match_jax(
        jm, params, tm, caption_batch(1), "caption",
        lambda out, b: jlosses.label_smoothed_nll(out, b["mask_ans"]), MLM)
    assert no_grad == {"enc_img.emb_odr"}


def _jax_generate(jm, params, img, **kw):
    return np.asarray(jax.jit(lambda p, im: jm.apply({"params": p}, im, MAX_LEN, **kw))(
        params, img))


def test_greedy_tokens_of_both_decoders_match_jax(built):
    """Greedy captions of the re-encoding decoder (``generate``, JAX's
    ``generate(use_cache=False)``) and of the K/V-cached one
    (``generate_cached``): identical to JAX's and to each other, [CLS]
    first."""
    jm, params, tm, batch, args = built
    img = args[0]
    want_full = _jax_generate(jm, params, img, use_cache=False, method=jm.generate)
    want_cached = _jax_generate(jm, params, img, method=jm.generate_cached)
    np.testing.assert_array_equal(want_full, want_cached)
    full = tm.generate(t_(batch)["img"], MAX_LEN)
    cached = tm.generate_cached(t_(batch)["img"], MAX_LEN)
    assert full.dtype == torch.int32 and full.shape == (B, MAX_LEN)
    np.testing.assert_array_equal(full.numpy(), want_full)
    np.testing.assert_array_equal(cached.numpy(), want_full)
    assert (full[:, 0] == tm.cls_token_id).all() and len(full[0, 1:].unique()) > 1


def test_beam_tokens_match_jax(built):
    """``generate_beam`` at 3 beams with the length penalty 0.6 equals JAX's;
    one beam without a penalty equals the greedy captions."""
    jm, params, tm, batch, args = built
    img = t_(batch)["img"]
    want = _jax_generate(jm, params, args[0], beam_size=3, method=jm.generate_beam)
    np.testing.assert_array_equal(tm.generate_beam(img, MAX_LEN, beam_size=3).numpy(), want)
    np.testing.assert_array_equal(
        tm.generate_beam(img, MAX_LEN, beam_size=1, length_penalty=0.0).numpy(),
        tm.generate(img, MAX_LEN).numpy())


def test_decoders_end_a_caption_at_sep(built):
    """After [SEP] a caption holds [PAD] in every decoder: the fc_mtm bias of
    [SEP] raised until the decoders pick it at some position."""
    _, _, tm, batch, _ = built
    img = t_(batch)["img"]
    bias = tm.fc_mtm.predictions.decoder.bias
    old = bias.detach().clone()
    with torch.no_grad():
        bias[tm.sep_token_id] += 0.5 * (bias.max() - bias.min()) + 3.0
    try:
        for toks in (tm.generate(img, MAX_LEN), tm.generate_cached(img, MAX_LEN),
                     tm.generate_beam(img, MAX_LEN, beam_size=3)):
            ended = (toks == tm.sep_token_id).cumsum(1) > 0
            after = ended & (toks != tm.sep_token_id)
            assert ended.any() and (toks[after] == tm.pad_token_id).all()
    finally:
        with torch.no_grad():
            bias.copy_(old)


@pytest.mark.parametrize("top_k,top_p,temperature", [
    (5, 0.0, 1.0), (0, 0.9, 1.0), (0, 0.0, 0.7), (5, 0.9, 0.7), (0, 0.5, 1.3), (1, 0.0, 1.0)])
def test_sampling_filter_matches_jax(monkeypatch, top_k, top_p, temperature):
    """The logits that ``_sample`` hands to ``jax.random.categorical``
    (captured by replacing it) equal :func:`filter_logits`'s, -inf where
    they filter; 200 draws of :func:`sample_next` from a generator stay in
    the kept set and, where it holds more than one token, take more than
    one; greedy is the argmax."""
    seen = {}

    def categorical(key, logits, axis=-1):
        seen["logits"] = np.asarray(logits)
        return jnp.argmax(logits, axis)

    monkeypatch.setattr(jax.random, "categorical", categorical)
    logits = (np.random.RandomState(5).randn(4, 50) * 2).astype(np.float32)
    jcap.VioletCaptioning._sample(None, jnp.asarray(logits), decode="sample", top_k=top_k,
                                  top_p=top_p, temperature=temperature, sub=None)
    got = tcap.filter_logits(torch.from_numpy(logits), top_k, top_p, temperature).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(seen["logits"]))
    np.testing.assert_array_equal(got[np.isfinite(got)], seen["logits"][np.isfinite(got)])
    kept = np.isfinite(got)
    gen = torch.Generator().manual_seed(6)
    draws = torch.stack([tcap.sample_next(torch.from_numpy(logits), "sample", top_k, top_p,
                                          temperature, gen) for _ in range(200)], 1).numpy()
    assert kept[np.arange(4)[:, None], draws].all()
    for row, k in zip(draws, kept.sum(1)):
        assert (len(set(row)) > 1) == (k > 1)
    np.testing.assert_array_equal(
        tcap.sample_next(torch.from_numpy(logits), temperature=temperature).numpy(),
        logits.argmax(1))


HYPS = {"v0": "a man is playing a guitar", "v1": "the dogs are running on grass",
        "v2": "someone cooking", "v3": ""}
REFS = {"v0": ["a man plays the guitar on stage", "a person is playing a guitar"],
        "v1": ["two dogs run across the grass", "dogs running in a field"],
        "v2": ["a woman is cooking food in a kitchen"], "v3": ["a cat sleeps"]}


def test_caption_metrics_match_jax():
    """Every metric and ``caption_scores`` equal the JAX module's on fixed
    hypotheses (an empty one too) and references, and on a corpus whose
    hypotheses are references (BLEU-4 100, CIDEr-D positive)."""
    for hyps, refs in ((HYPS, REFS), ({k: v[0] for k, v in REFS.items()}, REFS)):
        for name in ("bleu4", "cider_d", "rouge_l", "meteor", "caption_scores"):
            assert getattr(tmetrics, name)(hyps, refs) == getattr(jmetrics, name)(hyps, refs)
    scores = tmetrics.caption_scores({k: v[0] for k, v in REFS.items()}, REFS)
    assert scores["bleu4"] == pytest.approx(100.0) and scores["cider"] > 0
    assert all(np.isfinite(v) and v >= 0 for v in tmetrics.caption_scores(HYPS, REFS).values())


@pytest.fixture(scope="module")
def smtm_slice():
    """The pretrain slice of ``test_torch_pretrain`` with the ``smtm`` task."""
    yield from carried_slice(pretrain_cfg, pretrain_tasks=("mtm", "vtm", "mvm", "smtm"))


def test_smtm_losses_and_gradients_match_jax(smtm_slice):
    """``VioletPretrain.losses`` with ``smtm`` (the masked caption fused again
    under the seq2seq mask, ``fc_mtm`` against the MTM answers) and the
    same injected masks and negatives on both sides: every loss and every
    gradient against JAX; the smtm loss differs from the mtm one."""
    ls, jls, got, want, no_grad = losses_and_grads(smtm_slice, PRETRAIN_HEADS)
    assert set(ls) == {"mtm", "vtm", "smtm", "mvm_pixel", "total"} == set(jls)
    for k in ls:
        np.testing.assert_allclose(ls[k].item(), float(jls[k]), err_msg=k, **LOSS_TOL)
    assert abs(ls["smtm"].item() - ls["mtm"].item()) > 1e-4
    assert no_grad == {"enc_img.emb_odr"} and set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)


def test_fc_mtm_weight_carry_round_trip(built):
    """The captioning model's state_dict through the JAX importer with the
    caption CLI's ``heads`` map ({"fc_mtm": "mlm_head"}) and back through
    ``state_dict_from_flax`` is unchanged leaf for leaf; the tree has the
    leaves and shapes of the JAX ``init`` (``jax.eval_shape``)."""
    jm, params, tm, batch, args = built
    sd = convert.state_dict_from_flax(params, tm.config, MLM)
    assert set(sd) == set(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert torch.equal(sd[k], v), k
    want = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))["params"]
    assert jax.tree.map(lambda s: tuple(s.shape), want) == jax.tree.map(np.shape, params)


def test_capbench_functions_on_the_cpu(built):
    """The capbench tool's ``bench`` on each decoder (plain versions, no
    launches) and ``first_difference_margin``: None where two decoders
    agree, else the first differing position and a non-negative margin."""
    _, _, tm, batch, _ = built
    img = t_(batch)["img"]
    recs = {}
    for mode, kw in (("full", {}), ("cached", {}), ("full", {"beam_size": 2}),
                     ("full", {"decode": "sample", "top_k": 5})):
        rec, toks = capbench.bench(tm, img, mode, iters=1, max_len=MAX_LEN, **kw)
        assert toks.shape == (B, MAX_LEN) and rec["launches"] == {} and rec["captions_per_s"] > 0
        recs[rec["mode"] + rec["decode"]] = toks
    assert set(recs) == {"fullgreedy", "cachedgreedy", "beam2greedy", "fullsample"}
    assert capbench.first_difference_margin(tm, img, recs["fullgreedy"],
                                            recs["cachedgreedy"]) is None
    other = recs["fullgreedy"].clone()
    other[1, 3] = (other[1, 3] + 1) % BERT["vocab_size"]
    diff = capbench.first_difference_margin(tm, img, recs["fullgreedy"], other)
    assert diff["row"] == 1 and diff["position"] == 3 and diff["margin"] >= 0
