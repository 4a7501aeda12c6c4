"""The text encoder stack (``txt_backbone_embed_only`` false: a BERT
encoder over the text embeddings before the fusion) against the JAX package
at tiny widths, fp32 on the CPU, inputs from numpy with a seed.

``EncTxt`` alone under the ``full`` and ``seq2seq`` masks; a ``VioletPretrain``
(pixel target) with the stack: losses, gradients, the ``am`` rollout and two
steps, the masking draws injected as ``tests/test_torch_pretrain.py`` injects
them; the retrieval model's ``encode`` and ``score_pairs``; two QA-OE
``mlm`` steps with a prompt, which goes through the stack; the greedy
re-encoding decoder, token for token, and the K/V-cached decoder's refusal;
the ``.msgpack`` round trip and the CLI's adoption of the key from
``args.json``. The stack is a 2-layer BERT of hidden 32 (the fusion's
config, ``tests/test_torch_qa_heads.py``'s) with every dropout at 0. Weights
are drawn on the host and carried by ``models/convert.py``. Outputs within
atol 2e-5 / rtol 1e-4 (the pretrain slice's losses 1e-5 / 1e-4), gradients
within atol 2e-4 / rtol 1e-3 (fp32 summation order through the model).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (pins JAX to the CPU)
from tests.torch_threads import torch_threads  # noqa: F401  (the cores' share under xdist)

import jax
import jax.numpy as jnp

from empirical_mvm_tpu.core import config as jcfg
from empirical_mvm_tpu.models import captioning as jcap
from empirical_mvm_tpu.models import tasks as jtasks
from empirical_mvm_tpu.models import violet as jviolet
from empirical_mvm_torch.cli import common
from empirical_mvm_torch.core import config as tcfg
from empirical_mvm_torch.models import captioning as tcap
from empirical_mvm_torch.models import convert
from empirical_mvm_torch.models import tasks as ttasks
from empirical_mvm_torch.models import violet as tviolet
from empirical_mvm_torch.ops.preprocess import maybe_normalize
from empirical_mvm_torch.train import checkpoint
from tests.test_torch_pretrain import (HEADS, LOSS_TOL, _model_cfg, _t, assert_two_steps_match,
                                       carried_slice, drawn_params, losses_and_grads)
from tests.test_torch_qa_heads import (BERT, FWD_TOL, GRAD_TOL, MLM, PROMPT, _mlm_loss, _text,
                                       clips, qa_batch, t_, two_steps_match_jax)
from tests.test_torch_qa_heads import model_cfg as qa_cfg

STACK = dict(txt_backbone_embed_only=False)
B, X, MAX_LEN = 2, 8, 6


def _stacked(model_cfg):
    return lambda c: dataclasses.replace(model_cfg(c), **STACK)


def carried(tm, heads, seed=1):
    """The port model's parameters moved off their init by 0.05 N(0, 1)
    (loaded back into it) and the same values as the JAX tree
    (``convert.flax_from_state_dict``)."""
    rs = np.random.RandomState(seed)
    sd = {k: torch.from_numpy((v.numpy() + 0.05 * rs.randn(*v.shape)).astype(np.float32))
          for k, v in tm.state_dict().items()}
    tm.load_state_dict(sd)
    return convert.flax_from_state_dict(sd, tm.config, heads)


def _grads_match(got, want):
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("attn_mask_type", ["full", "seq2seq"])
def test_enc_txt_stack_matches_jax(attn_mask_type):
    """``EncTxt`` with the 2-layer stack: the output under a padding mask
    (``full``) or the causal one (``seq2seq``, the mask not read), and the
    gradients of every parameter."""
    cfg_t, cfg_j = qa_cfg(tcfg, **STACK), qa_cfg(jcfg, **STACK)
    rs = np.random.RandomState(0)
    txt, mask = _text(rs, 3)
    jm = jviolet.EncTxt(config=cfg_j)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(txt),
                                            jnp.asarray(mask)))["params"]
    params = drawn_params(shapes, np.random.RandomState(1))
    tm = tviolet.EncTxt(cfg_t)
    tm.load_state_dict({**convert.bert_embeddings_state_dict(params["emb_txt"], "emb_txt."),
                        **convert.bert_encoder_state_dict(params["txt_trsfr"], 2, "txt_trsfr.")})
    out = tm(torch.from_numpy(txt), mask_txt=torch.from_numpy(mask),
             attn_mask_type=attn_mask_type)
    w = rs.randn(*out.shape).astype(np.float32)
    (out * torch.from_numpy(w)).sum().backward()

    def loss(p):
        o = jm.apply({"params": p}, jnp.asarray(txt), jnp.asarray(mask), attn_mask_type)
        return jnp.sum(o * w), o

    (_, jout), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **FWD_TOL)
    want = {**convert.bert_embeddings_state_dict(jax.tree.map(np.asarray, jg["emb_txt"]),
                                                 "emb_txt."),
            **convert.bert_encoder_state_dict(jax.tree.map(np.asarray, jg["txt_trsfr"]), 2,
                                              "txt_trsfr.")}
    _grads_match({n: p.grad for n, p in tm.named_parameters()}, want)
    with torch.no_grad():
        other = tm(torch.from_numpy(txt), mask_txt=torch.ones_like(torch.from_numpy(mask)),
                   attn_mask_type=attn_mask_type)
    moved = (other - out).abs().amax(dim=(1, 2))
    if attn_mask_type == "full":
        assert (moved[mask.sum(1) < X] > 1e-4).all()   # the padding mask is read
    else:
        assert moved.max() == 0                         # and the causal one is not


@pytest.fixture(scope="module")
def stack_slice():
    """The tiny pixel slice of ``tests/test_torch_pretrain.py`` with the text
    stack, its draws injected, its weights drawn on the host."""
    yield from carried_slice(_stacked(_model_cfg),
                             drawn=lambda shapes: drawn_params(shapes, np.random.RandomState(2)))


@pytest.fixture(scope="module")
def stack_grads(stack_slice):
    return losses_and_grads(stack_slice)


def test_pretrain_losses_gradients_and_rollout_with_the_stack_match_jax(stack_slice,
                                                                        stack_grads):
    """The pretrain losses and every gradient (the stack's layers among
    them), and the ``am`` rollout (``get_att``), which reaches the stack
    through ``go_feat``."""
    ls, jls, got, want, no_grad = stack_grads
    assert any(n.startswith("enc_txt.txt_trsfr.layer.1.") for n in got)
    for k in ls:
        np.testing.assert_allclose(ls[k].item(), float(jls[k]), err_msg=k, **LOSS_TOL)
    _grads_match(got, want)
    jm, params, tm = stack_slice["jm"], stack_slice["params"], stack_slice["tm"]
    assert not {n for n in no_grad if n.startswith("enc_txt.")}
    want_att = jax.jit(lambda p: jm.apply({"params": p}, *stack_slice["args"],
                                          method=jm.get_att))(params)
    b = _t(stack_slice["batch"])
    got_att = tm.get_att(maybe_normalize(b["img"]), b["txt"], b["mask"])
    np.testing.assert_allclose(got_att.numpy(), np.asarray(want_att), rtol=1e-5, atol=1e-6)


def test_two_pretrain_steps_with_the_stack_match_jax(stack_slice, stack_grads):
    """Two ``make_pretrain_train_step`` steps against JAX's, held as
    ``tests/test_torch_pretrain.py`` holds them."""
    got, _ = assert_two_steps_match(stack_slice, stack_grads, HEADS, outliers=1e-4)
    assert not torch.equal(got["enc_txt.txt_trsfr.layer.0.attention.self.query.weight"],
                           stack_slice["tm"].state_dict()[
                               "enc_txt.txt_trsfr.layer.0.attention.self.query.weight"])


def test_retrieval_encode_and_score_pairs_match_jax():
    """``VioletRetrieval.encode`` (the captions through the stack under
    their padding mask) and ``score_pairs`` of mixed (video, caption) rows."""
    tm = ttasks.VioletRetrieval(qa_cfg(tcfg, **STACK), device="cpu", seed=2)
    tm.fc[0].p = 0.0
    jm = jtasks.VioletRetrieval(config=qa_cfg(jcfg, **STACK))
    params = carried(tm, {"fc": "score_head"})
    rs = np.random.RandomState(3)
    img, (txt, mask) = clips(rs), _text(rs, B)
    args = [jnp.asarray(a) for a in (img, txt, mask)]
    jfi, jmi, jft, jmt = jax.jit(lambda p, *a: jm.apply({"params": p}, *a,
                                                        method=jm.encode))(params, *args)
    with torch.no_grad():
        fi, mi, ft, mt = tm.encode(*(torch.from_numpy(a) for a in (img, txt, mask)))
    for got, want in ((fi, jfi), (ft, jft)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    np.testing.assert_array_equal(mi.numpy(), np.asarray(jmi))
    vj, ti = [0, 1, 1, 0], [0, 0, 1, 1]
    want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, method=jm.score_pairs))(
        params, jfi[jnp.asarray(vj)], jmi[jnp.asarray(vj)], jft[jnp.asarray(ti)],
        jmt[jnp.asarray(ti)])
    with torch.no_grad():
        got = tm.score_pairs(fi[vj], mi[vj], ft[ti], mt[ti])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_two_qaoe_prompt_steps_through_the_stack_match_jax():
    """The open-ended MLM head with ``enable_prompt``: the prompt goes through
    the stack under its own mask (``prepend_pretxt``); two ``mlm`` steps
    against the JAX agent's."""
    prompt = tuple(int(i) for i in PROMPT)
    cfg = dict(STACK, enable_prompt=True)
    tm = ttasks.VioletQAOEMLMHead(qa_cfg(tcfg, **cfg), device="cpu", seed=3,
                                  prompt_tokens=prompt)
    jm = jtasks.VioletQAOEMLMHead(config=qa_cfg(jcfg, **cfg), prompt_tokens=prompt,
                                  prompt_mask_static=(1,) * len(prompt))
    params = carried(tm, MLM)
    no_grad = two_steps_match_jax(jm, params, tm, qa_batch("oe_mlm"), "mlm", _mlm_loss, MLM)
    assert no_grad == {"enc_img.emb_odr"}


def test_greedy_decoder_matches_jax_and_the_cached_decoder_refuses_the_stack():
    """The re-encoding greedy decoder (every position re-runs the stack over
    the caption so far) gives JAX's ``generate(use_cache=False)`` tokens in
    fp32; ``generate_cached`` refuses the stack in both packages."""
    tm = tcap.VioletCaptioning(qa_cfg(tcfg, **STACK), device="cpu", seed=4)
    jm = jcap.VioletCaptioning(config=qa_cfg(jcfg, **STACK))
    params = carried(tm, MLM)
    img = clips(np.random.RandomState(5))
    want = np.asarray(jax.jit(lambda p, im: jm.apply(
        {"params": p}, im, MAX_LEN, use_cache=False, method=jm.generate))(params,
                                                                          jnp.asarray(img)))
    got = tm.generate(torch.from_numpy(img), MAX_LEN)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want[:, 1:])) > 1
    with pytest.raises(ValueError, match="embeddings-only"):
        tm.generate_cached(torch.from_numpy(img), MAX_LEN)
    with pytest.raises(AssertionError, match="embeddings-only"):
        jm.apply({"params": params}, jnp.asarray(img), MAX_LEN, method=jm.generate_cached)


def test_msgpack_round_trip_and_the_cli_adopting_the_stack(tmp_path):
    """A model with the stack saved as ``.msgpack`` and read back bit-equal;
    the file's tree is the JAX ``init``'s (``jax.eval_shape``). A run whose
    config lacks the key adopts ``txt_backbone_embed_only`` from the
    ``args.json`` beside the checkpoint, as the eval CLIs do, and
    ``load_initial_params`` fills every leaf of the stack from the file."""
    tm = ttasks.VioletRetrieval(qa_cfg(tcfg, **STACK), device="cpu", seed=6)
    sd = tm.state_dict()
    path = str(tmp_path / "ckpt" / "model_best.msgpack")
    checkpoint.save_params(tm, path)
    back = checkpoint.load_params(path)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    jm = jtasks.VioletRetrieval(config=qa_cfg(jcfg, **STACK))
    rs = np.random.RandomState(7)
    args = [jnp.asarray(a) for a in (clips(rs), *_text(rs, B))]
    want = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))["params"]
    tree = checkpoint.load_tree(path)
    assert (jax.tree.map(lambda s: tuple(s.shape), want)
            == jax.tree.map(lambda a: tuple(np.shape(a)), tree))
    with open(tmp_path / "ckpt" / "args.json", "w") as f:
        json.dump({"model": {"txt_backbone_embed_only": False}}, f)
    run = dataclasses.replace(tcfg.load_run_config({}), path_ckpt=path)
    run = dataclasses.replace(run, model=qa_cfg(tcfg))
    assert run.model.txt_backbone_embed_only
    run = common.adopt_ckpt_args(run)
    assert not run.model.txt_backbone_embed_only
    fresh = ttasks.VioletRetrieval(run.model, device="cpu", seed=8)
    report = common.load_initial_params(run, fresh)
    assert not report["kept"] and not report["ignored"]
    stack = [k for k in sd if k.startswith("enc_txt.txt_trsfr.")]
    assert len(stack) == 2 * 16
    for k in stack:
        assert torch.equal(fresh.state_dict()[k], sd[k]), k
