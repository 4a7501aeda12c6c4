"""Retrieval fine-tuning in the port against the JAX package at tiny widths
on the CPU, fp32, inputs from numpy with a seed: ``VioletRetrieval``'s
training pass (the all-pairs scores), two ``nce`` steps against the JAX
``RetrievalAgent`` step, ``norm_softmax_loss`` and
``in_batch_retrieval_accuracy``. The model, its carried weights and the
step comparison are ``tests/test_torch_qa_heads.py``'s; 3 clips and 3
captions make 9 fusion rows.
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
from empirical_mvm_tpu.models import tasks as jtasks
from empirical_mvm_tpu.train import evaluators as jeval
from empirical_mvm_tpu.train import losses as jlosses
from empirical_mvm_torch.core import config as tcfg
from empirical_mvm_torch.models import convert
from empirical_mvm_torch.models.tasks import VioletRetrieval
from empirical_mvm_torch.train import evaluators as teval
from empirical_mvm_torch.train import losses as tlosses
from empirical_mvm_torch.train.train_step import make_eval_step
from tests.test_torch_qa_heads import (BERT, FWD_TOL, SCORE, _text, carry, clips, jax_forward,
                                       model_cfg, t_, two_steps_match_jax)
from tests.test_torch_qa_heads import jax_scorehead  # noqa: F401  (the module fixture)

B = 3
TEMP = 0.05


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    txt, mask = _text(rs, B)
    return {"img": clips(rs, B), "txt": txt, "mask": mask}


def _build(seed=2, **switches):
    tm = VioletRetrieval(model_cfg(tcfg, **switches), device="cpu", seed=seed)
    tm.fc[0].p = 0.0
    jm = jtasks.VioletRetrieval(config=model_cfg(jcfg, **switches))
    params = carry(tm, jm.config, SCORE)
    batch = _batch()
    return jm, params, tm, batch, [jnp.asarray(batch[k]) for k in ("img", "txt", "mask")]


@pytest.fixture(scope="module")
def retrieval(jax_scorehead):
    return _build()


def test_training_forward_matches_jax(retrieval):
    """The all-pairs scores (B, B) of the training pass (a generator, every
    rate 0) and of the eval against the JAX model's ``deterministic=False``
    and ``True``; the pairs are row-major, video i against caption j."""
    jm, params, tm, batch, args = retrieval
    want = jax_forward(jm, params, args, deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(0)})
    got = tm(*(t_(batch)[k] for k in ("img", "txt", "mask")),
             generator=torch.Generator().manual_seed(1))
    assert got.shape == (B, B) and got.requires_grad
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD_TOL)
    eval_scores = make_eval_step(tm)(t_(batch))
    np.testing.assert_allclose(eval_scores.numpy(), jax_forward(jm, params, args), **FWD_TOL)
    assert torch.equal(eval_scores, got.detach())


def test_eval_forward_is_score_pairs_of_the_same_rows(retrieval):
    """The eval forward is the two-stage eval's ``score_pairs`` over
    ``encode``'s features, paired row-major: equal on the same rows."""
    _, _, tm, batch, _ = retrieval
    img, txt, mask = (t_(batch)[k] for k in ("img", "txt", "mask"))
    with torch.no_grad():
        fi, mi, ft, mt = tm.encode(img, txt, mask)
        vj, ti = np.repeat(np.arange(B), B), np.tile(np.arange(B), B)
        pairs = tm.score_pairs(fi[vj], mi[vj], ft[ti], mt[ti]).reshape(B, B)
        torch.testing.assert_close(tm(img, txt, mask), pairs, atol=1e-6, rtol=0)


def test_training_pass_draws_dropout_from_the_generator(jax_scorehead):
    """At the config's dropout (0.1 in the fusion and the score head) the
    training pass differs from the eval and repeats with the same seed; the
    eval is deterministic (the model holds no train/eval switch: the
    generator decides)."""
    fusion = tcfg.BertConfig(**{**BERT, "hidden_dropout_prob": 0.1,
                                "attention_probs_dropout_prob": 0.1})
    tm = VioletRetrieval(dataclasses.replace(model_cfg(tcfg), fusion=fusion), device="cpu",
                         seed=4)
    assert tm.fc[0].p == 0.1
    args = [t_(_batch())[k] for k in ("img", "txt", "mask")]
    with torch.no_grad():
        a, b = (tm(*args, generator=torch.Generator().manual_seed(5)) for _ in range(2))
        c = tm(*args, generator=torch.Generator().manual_seed(6))
        e1, e2 = tm(*args), tm(*args)
    assert torch.equal(a, b) and torch.equal(e1, e2)
    assert (a - e1).abs().max() > 1e-4 and (a - c).abs().max() > 1e-4


def test_two_nce_steps_match_the_jax_retrieval_agent_step(jax_scorehead):
    """Two ``make_supervised_train_step("nce")`` steps at the run's ``temp``
    against the JAX ``RetrievalAgent`` step (``norm_softmax_loss`` of the
    training pass's scores): losses, step-0 gradients and parameters as
    ``test_two_ce_steps_match_the_jax_qamc_step`` holds them."""
    jm, params, tm, batch, _ = _build(seed=3)
    no_grad = two_steps_match_jax(jm, params, tm, batch, "nce",
                                  lambda out, b: jlosses.norm_softmax_loss(out, TEMP),
                                  SCORE, temp=TEMP)
    assert no_grad == {"enc_img.emb_odr"}


def test_weight_carry_round_trip_of_the_retrieval_heads_map(retrieval):
    """The ``{"fc": "score_head"}`` map of JAX cli/retrieval.py: the carried
    tree back through ``state_dict_from_flax`` is the port's state_dict,
    and has the leaves and shapes of the JAX ``init``."""
    jm, params, tm, _, args = retrieval
    sd = convert.state_dict_from_flax(params, tm.config, SCORE)
    assert set(sd) == set(tm.state_dict())
    assert all(torch.equal(sd[k], v) for k, v in tm.state_dict().items())
    want = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))["params"]
    assert jax.tree.map(lambda s: tuple(s.shape), want) == jax.tree.map(np.shape, params)


@pytest.mark.parametrize("temp", [0.05, 1.0])
def test_norm_softmax_loss_matches_jax(temp):
    """On seeded (B, B) scores, fp32 and bf16 (cast to fp32 before the
    division, as in JAX); its gradient too."""
    rs = np.random.RandomState(13)
    s = rs.randn(6, 6).astype(np.float32)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        x = torch.from_numpy(s).to(dtype).requires_grad_(True)
        got = tlosses.norm_softmax_loss(x, temp)
        got.backward()
        want, jg = jax.value_and_grad(lambda a: jlosses.norm_softmax_loss(a, temp))(
            jnp.asarray(s, jdtype))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(x.grad.float().numpy(), np.asarray(jg, np.float32),
                                   rtol=1e-2 if dtype == torch.bfloat16 else 1e-5, atol=1e-7)


def test_in_batch_retrieval_accuracy_matches_jax():
    rs = np.random.RandomState(14)
    s = rs.randn(8, 8).astype(np.float32)
    s[[0, 3, 5], [0, 3, 5]] += 10.0
    assert teval.in_batch_retrieval_accuracy(s) == jeval.in_batch_retrieval_accuracy(s)
    assert teval.in_batch_retrieval_accuracy(s) >= 3 / 8
    assert teval.in_batch_retrieval_accuracy(np.eye(4)) == 1.0
