"""The fine-tune steps across two gloo ranks (``tests/dp_worker.py``) on the
CPU: the retrieval ``nce`` step, whose (B, B) score matrix mixes every row
of the global batch, and the multiple-choice ``ce`` step, whose mean runs
over the labels that are not -1 of the whole batch. Each against the port
on one process and against the JAX agent's step (its pieces, as
``tests/test_torch_qa_heads.py`` builds them) jitted on a 2-device mesh, the
batch sharded on ``data``.

The models are ``test_torch_qa_heads.py``'s (every dropout rate 0, fp32),
at B = 4: rank r holds rows r::2. The multiple-choice batches put every -1
label on rank 0 (a rank with no label: a local mean averaged over the ranks
halves the loss), and one -1 on each rank besides an uneven count (a local
denominator summed over the ranks overweights the rank with fewer labels).
Tolerances as in ``test_torch_data_parallel.py``, but for the ``nce``
step-0 gradients, held to 1e-4 of their tensor's largest element plus 2e-5:
the loss divides the scores by the temperature 0.05, so a score's roundoff
reaches the softmax 20 times larger (the score head's output bias, whose
gradient is zero in exact arithmetic, holds that roundoff alone).
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
from empirical_mvm_tpu.models import tasks as jtasks
from empirical_mvm_tpu.parallel import mesh as jmesh
from empirical_mvm_tpu.train import losses as jlosses
from empirical_mvm_torch.core import config as tcfg
from empirical_mvm_torch.models import convert
from empirical_mvm_torch.models import tasks as ttasks
from tests.dp_worker import run_ranks, train
from tests.test_torch_data_parallel import (LR, RANK_LOSS, assert_grads_close,
                                            assert_steps_close)
from tests.test_torch_qa_heads import (LOSS_TOL, MAX_ITER, O, SCORE, X, _text, carry, clips,
                                       jax_tx, model_cfg)
from tests.test_torch_qa_heads import jax_scorehead  # noqa: F401  (the module fixture)

B = 4
TEMP = 0.05
MC_LABELS = {"all_ignored_on_rank_0": [-1, 1, -1, 2], "uneven": [-1, 1, 0, -1]}


def jax_mesh_step(jm, tx, loss_fn):
    """The JAX agent's step (``value_and_grad`` of the training pass, the
    optax update) jitted on a 2-device mesh: state replicated, batch
    sharded on ``data``."""
    mesh2 = jmesh.make_mesh(2)

    def step(params, opt_state, batch):
        def loss(p):
            out = jm.apply({"params": p}, batch["img"], batch["txt"], batch["mask"],
                           deterministic=False, rngs={"dropout": jax.random.PRNGKey(7)})
            return loss_fn(out, batch)

        value, grads = jax.value_and_grad(loss)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, value, grads

    rep, bsh = jmesh.replicated(mesh2), jmesh.batch_sharding(mesh2)
    return jax.jit(step, in_shardings=(rep, rep, bsh), out_shardings=rep)


def _case(port_cls, jax_cls, loss_kind, loss_fn, batches, tmp_path, tol=(1e-5, 1e-6)):
    """Two steps at two ranks, on one process and in JAX on the mesh, from
    the same carried parameters; each batch its own run."""
    tm = port_cls(model_cfg(tcfg), device="cpu", seed=2)
    tm.fc[0].p = 0.0
    jm = jax_cls(config=model_cfg(jcfg))
    params = carry(tm, jm.config, SCORE)
    jobs = [dict(kind="train", model=name, config=tm.config, state_dict=tm.state_dict(),
                 steps=2, lr=LR, loss_kind=loss_kind, temp=TEMP,
                 batches=[{k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}])
            for name, batch in batches]
    two = run_ranks(jobs, tmp_path)
    tx = jax_tx(params, jcfg.load_run_config({"lr": LR}).train)
    jstep = jax_mesh_step(jm, tx, loss_fn)
    for i, (_, batch) in enumerate(batches):
        got, one = two[0][i], train(jobs[i], None)
        for lg, lw in zip(got["losses"], one["losses"]):
            np.testing.assert_allclose(lg["total"], lw["total"], **RANK_LOSS)
        assert_grads_close(got["grads0"], one["grads0"], loss_kind, *tol)
        assert_steps_close(got["params"], one["params"], one["grads0"], got["grads0"], "one")
        for n, p in got["params"].items():
            assert torch.equal(p, two[1][i]["params"][n]), n
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jp, js = params, tx.init(params)
        for s in range(2):
            jp, js, jloss, jg = jstep(jp, js, jb)
            np.testing.assert_allclose(got["losses"][s]["total"], float(jloss), **LOSS_TOL)
            if s == 0:
                jgrads = convert.state_dict_from_flax(jax.tree.map(np.asarray, jg), tm.config,
                                                      SCORE)
        want = convert.state_dict_from_flax(jax.tree.map(np.asarray, jp), tm.config, SCORE)
        assert_steps_close(got["params"], want, jgrads, got["grads0"], "jax")


def test_nce_step_at_two_ranks_matches_one_process_and_jax_on_a_mesh(jax_scorehead,
                                                                      tmp_path):
    """Rank r scores its 2 videos against the 4 gathered captions; the
    loss's rows and columns are gathered into the whole matrix."""
    rs = np.random.RandomState(0)
    txt, mask = _text(rs, B)
    batch = {"img": clips(rs, B), "txt": txt, "mask": mask}
    _case(ttasks.VioletRetrieval, jtasks.VioletRetrieval, "nce",
          lambda out, b: jlosses.norm_softmax_loss(out, TEMP), [("retrieval", batch)],
          tmp_path, tol=(1e-4, 2e-5))


def test_mc_ce_step_at_two_ranks_with_the_ignored_labels_on_one_rank(jax_scorehead, tmp_path):
    rs = np.random.RandomState(1)
    img = clips(rs, B)
    txt, mask = _text(rs, B * O)
    batches = [("qamc", {"img": img, "txt": txt.reshape(B, O, X), "mask": mask.reshape(B, O, X),
                         "ans": np.array(labels, np.int32)}) for labels in MC_LABELS.values()]
    assert np.all(batches[0][1]["ans"][0::2] == -1) and np.all(batches[0][1]["ans"][1::2] >= 0)
    _case(ttasks.VioletQAMC, jtasks.VioletQAMC, "ce",
          lambda out, b: jlosses.cross_entropy_ignore(out, b["ans"]), batches, tmp_path)
