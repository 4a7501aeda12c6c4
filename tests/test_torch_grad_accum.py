"""Gradient accumulation (``grad_accum``) against ``optax.MultiSteps``, as the
JAX ``build_optimizer`` wraps its chain, on the CPU in fp32.

``MultiSteps`` keeps a running mean of the micro-gradients (optax's Welford
update ``acc + (g - acc) / (n + 1)``); every k-th micro-step it runs the
clip and AdamW on the mean, whose ``count`` (the schedule's step and the
bias corrections) then advances, and resets the mean; the parameters do not
move in between. Held after every micro-step: parameters, both moments, the
count, the micro-step and the learning rate, at 1e-7 (both sides run the
same fp32 operations; XLA may fuse them in another order). Then a tiny
pretrain run with ``grad_accum`` 2 against the JAX step with the JAX
agent's optimizer, at ``test_torch_pretrain.py``'s tolerances.
"""

import copy

import numpy as np
import optax
import pytest
import torch
from torch import nn

import tests.conftest  # noqa: F401  (pins JAX to the CPU)

import jax
import jax.numpy as jnp

from empirical_mvm_tpu.train import optimizer as jopt
from empirical_mvm_tpu.train import train_step as jts
from empirical_mvm_torch.models import convert
from empirical_mvm_torch.train import optimizer as topt
from empirical_mvm_torch.train.train_step import create_train_state, make_pretrain_train_step
from tests.test_torch_pretrain import HEADS, LOSS_TOL, _t, losses_and_grads
from tests.test_torch_pretrain import slice_  # noqa: F401  (the module fixture)

LR, MAX_ITER = 1e-2, 10
TOL = dict(atol=1e-7, rtol=1e-6)
SHAPES = {("swin", "kernel"): (4, 3), ("swin", "bias"): (3,), ("head", "kernel"): (3, 2),
          ("head", "bias"): (2,)}


class _Tiny(nn.Module):
    """Parameters named as the JAX tree's paths: one of each group."""

    def __init__(self, values):
        super().__init__()
        for (mod, leaf), v in values.items():
            if not hasattr(self, mod):
                self.add_module(mod, nn.Module())
            getattr(self, mod).register_parameter(leaf, nn.Parameter(torch.from_numpy(v)))


def _leaves(tree, what):
    """Every ``what`` leaf of an optax state that is not masked out, by the
    port's dotted name."""
    out = {}
    for _, sub in optax.tree_utils.tree_get_all_with_path(tree, what):
        for path, leaf in jax.tree_util.tree_leaves_with_path(sub):
            if isinstance(leaf, optax.MaskedNode) or not hasattr(leaf, "shape"):
                continue
            out[".".join(p.key for p in path)] = np.asarray(leaf)
    return out


@pytest.mark.parametrize("k", [2, 3])
def test_grad_accum_matches_optax_multisteps_after_every_micro_step(k):
    rs = np.random.RandomState(k)
    values = {p: rs.randn(*s).astype(np.float32) for p, s in SHAPES.items()}
    params = {m: {leaf: jnp.asarray(values[(m, leaf)]) for (mm, leaf) in SHAPES if mm == m}
              for m in ("swin", "head")}
    tx = jopt.build_optimizer(params, lr=LR, max_iter=MAX_ITER, grad_accum=k)
    jstate = tx.init(params)
    model = _Tiny(values)
    opt = topt.AdamW(model, LR, MAX_ITER, grad_accum=k)
    tparams = dict(model.named_parameters())
    state = opt.init(tparams)
    schedule = jopt.warmup_linear_schedule(LR, MAX_ITER)
    for i in range(3 * k + 1):
        grads = {p: (3 * rs.randn(*s)).astype(np.float32) for p, s in SHAPES.items()}
        jgrads = {m: {leaf: jnp.asarray(grads[(m, leaf)]) for (mm, leaf) in SHAPES if mm == m}
                  for m in ("swin", "head")}
        updates, jstate = tx.update(jgrads, jstate, params)
        params = optax.apply_updates(params, updates)
        before = {n: p.detach().clone() for n, p in tparams.items()}
        state = opt.update(tparams, {f"{m}.{leaf}": torch.from_numpy(g)
                                     for (m, leaf), g in grads.items()}, state)
        emitted = i % k == k - 1
        inner = jstate.gradient_step
        assert state["count"] == int(inner) == (i + 1) // k, i
        assert state["mini_step"] == int(jstate.mini_step) == (i + 1) % k
        assert opt.schedules["other_decay"](state["count"]) == pytest.approx(
            float(schedule(inner)), rel=1e-6)
        for name, p in tparams.items():
            m, leaf = name.split(".")
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[m][leaf]),
                                       err_msg=(i, name), **TOL)
            assert emitted or torch.equal(p.detach(), before[name]), (i, name)
        for what in ("mu", "nu"):
            want = _leaves(jstate.inner_opt_state, what)
            assert set(want) == set(state[what])
            for name, v in want.items():
                np.testing.assert_allclose(state[what][name].numpy(), v, err_msg=(i, what, name),
                                           **TOL)


def test_pretrain_with_grad_accum_matches_the_jax_step_with_multisteps(slice_):
    """Four micro-steps of the pixel slice with ``grad_accum`` 2 (two
    updates): the losses of every micro-step, the parameters unchanged
    after the first and third, and after the fourth held to the JAX
    ``make_pretrain_train_step`` with the JAX agent's optimizer as
    ``test_torch_pretrain.py`` holds two steps."""
    jm, params = slice_["jm"], slice_["params"]
    tm = copy.deepcopy(slice_["tm"])
    _, _, got_g, want_g, _ = losses_and_grads(slice_)
    tx = jopt.build_optimizer(params, lr=1e-3, max_iter=10, grad_accum=2)
    jstep = jts.make_pretrain_train_step(jm, tx, mesh=None, donate=False)
    jstate = jts.create_train_state(params, tx)
    jbatch = {k: jnp.asarray(v) for k, v in slice_["batch"].items()}
    opt = topt.AdamW(tm, 1e-3, 10, grad_accum=2)
    state = create_train_state(tm, opt)
    step = make_pretrain_train_step(tm, opt)
    batch = dict(_t(slice_["batch"]), draws=slice_["draws"], neg_idx=slice_["neg_idx"])
    for i in range(4):
        before = {n: p.detach().clone() for n, p in tm.named_parameters()}
        jstate, jls = jstep(jstate, jbatch, jax.random.PRNGKey(7))
        state, ls = step(state, batch, 7)
        np.testing.assert_allclose(ls["total"].item(), float(jls["total"]), **LOSS_TOL)
        if i % 2 == 0:
            assert all(torch.equal(p.detach(), before[n]) for n, p in tm.named_parameters())
    assert state.step == 4 and state.opt_state["count"] == 2
    want = convert.state_dict_from_flax(jax.tree.map(np.asarray, jstate.params), tm.config,
                                        HEADS)
    for name, p in tm.named_parameters():
        g = want_g[name].abs()
        resolved = (g > 100 * (got_g[name] - want_g[name]).abs()) & (g > 1e-6)
        d = (p.detach() - want[name]).abs()
        assert d.max().item() <= 2e-3 + 2e-6, name
        if resolved.any():
            assert d[resolved].max().item() <= 2e-6, name
