"""Data parallelism of the port on the CPU: two gloo ranks, spawned as
``tests/dp_worker.py`` processes (a file rendezvous, no port), against the
port on one process and against the JAX package's pretrain step on a
2-device mesh (``tests/conftest.py``'s virtual CPU devices).

The model and the fixed draws are ``tests/test_torch_pretrain.py``'s tiny
pixel slice (B = 4, so 2 rows a rank, every dropout rate 0, fp32). Rank r
holds rows r::2 of the global batch, as the loader splits them.

Tolerances. Two ranks sum the same terms as one process in another order:
losses within 1e-6; step-0 gradients, each a sum over the batch, within
1e-5 of their tensor's largest element plus 1e-6 (a gradient that is zero in
exact arithmetic, such as the key biases', holds roundoff alone). After two
AdamW steps, elements whose gradient is resolved (above 100x the two runs'
gradient difference and 1e-6) are held to 2e-6, the rest to Adam's bound of
2 lr + 2e-6 (Adam divides a roundoff-level gradient by its own size); at
most 1e-4 of the resolved ones may exceed 2e-6. Against JAX the tolerances
of ``test_torch_pretrain.py``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (pins JAX to the CPU)
from tests.torch_threads import torch_threads  # noqa: F401  (the cores' share under xdist)

import jax
import jax.numpy as jnp

from empirical_mvm_tpu.parallel import mesh as jmesh
from empirical_mvm_tpu.train import optimizer as jopt
from empirical_mvm_tpu.train import train_step as jts
from empirical_mvm_torch.models import convert
from empirical_mvm_torch.models.tasks import VioletRetrieval
from empirical_mvm_torch.parallel import mesh
from empirical_mvm_torch.train.checkpoint import load_tree
from empirical_mvm_torch.models.pretrain import VioletPretrain
from empirical_mvm_torch.train.checkpoint import load_params, load_train_state
from empirical_mvm_torch.train.optimizer import build_optimizer
from empirical_mvm_torch.train.train_step import create_train_state
from tests import synth_data
from tests.dp_worker import batch_norm, run_ranks, train, two_stage
from tests.test_torch_pretrain import HEADS, LOSS_TOL, _model_cfg, _t, carried_slice
from tests.test_torch_qa_heads import _text, clips, model_cfg

from empirical_mvm_torch.core import config as tcfg

LR = 1e-3
RANK_LOSS = dict(atol=1e-6, rtol=1e-6)
# the am run below: VTM divides its logits by temp 0.05, so the fusion's
# roundoff in another summation order reaches the loss 20-fold (read 1.5e-6
# relative)
RANK_LOSS_TEMP = dict(atol=1e-5, rtol=1e-5)


def assert_grads_close(got, want, what, rel=1e-5, floor=1e-6):
    for n, g in want.items():
        tol = rel * g.abs().max().item() + floor
        assert (got[n] - g).abs().max().item() <= tol, (what, n)


def assert_steps_close(got, want, g_want, g_got, what):
    """``got`` against ``want`` after two AdamW steps at ``LR``, elements
    resolved by the step-0 gradients ``g_want`` / ``g_got`` held to 2e-6,
    the rest to Adam's bound."""
    resolved_n, over = 0, []
    for name, w in want.items():
        g = g_want[name].abs()
        resolved = (g > 100 * (g_got[name] - g_want[name]).abs()) & (g > 1e-6)
        resolved_n += int(resolved.sum())
        d = (got[name] - w).abs()
        assert d.max().item() <= 2 * LR + 2e-6, (what, name, d.max().item())
        if resolved.any() and d[resolved].max().item() > 2e-6:
            over.append((name, int((d[resolved] > 2e-6).sum()), d[resolved].max().item()))
    assert resolved_n > 0
    assert sum(n for _, n, _ in over) <= 1e-4 * resolved_n, (what, over)


def _pretrain_config(tmp):
    """A pretrain task file over a ``tests/synth_data.py`` layout: 8 videos
    in two shards, batch 4 (2 rows a rank), with ``fsdp`` (every block
    sharded) and ``remat`` on the swin and the fusion."""
    synth_data.write_vocab(str(tmp / "vocab.txt"))
    synth_data.make_pretrain(str(tmp / "data"), "webvid2.5m")
    over = synth_data.TINY_RUN_OVERRIDES
    cfg = {"type": "pretrain", "task": "pretrain", "dataset": ["webvid2.5m"],
           "data_dir": str(tmp / "data"), "path_output": str(tmp / "out"),
           "tokenizer": str(tmp / "vocab.txt"), "lr": 1e-3, "size_part": 2, **over,
           "fsdp": True, "fsdp_min_size": 0,
           "swin_custom": dict(over["swin_custom"], remat=True),
           "fusion": dict(over["fusion"], remat=True)}
    (tmp / "pretrain.json").write_text(json.dumps(cfg))
    return str(tmp / "pretrain.json")


def _eval_items():
    """Five (caption, video) items over four videos (items 3 and 4 share
    one): clip counts 1 and 2, so stage 1 runs three batches of at most 2,
    and stage 2 five chunks of 4 of the 20 pairs; neither divides over two
    ranks."""
    rs = np.random.RandomState(5)
    txt, mask = _text(rs, 5)
    vids = ["v0", "v1", "v2", "v3", "v3"]
    counts = [1, 2, 1, 2, 2]
    items = [{"img": torch.from_numpy(clips(rs, counts[i])), "txt": torch.from_numpy(txt[i]),
              "mask": torch.from_numpy(mask[i]), "vid": vids[i], "tid": f"t{i}"}
             for i in range(5)]
    return items, {f"t{i}": v for i, v in enumerate(vids)}


@pytest.fixture(scope="module")
def slice_():
    yield from carried_slice(_model_cfg)


@pytest.fixture(scope="module")
def runs(slice_, tmp_path_factory):
    """The jobs at two ranks (one spawn) and the same jobs on one process."""
    tmp = tmp_path_factory.mktemp("dp")
    tm = slice_["tm"]
    batch = _t(slice_["batch"])
    base = dict(kind="train", model="pretrain", config=tm.config, state_dict=tm.state_dict(),
                steps=2, lr=LR)
    jobs = {
        "helpers": {"kind": "helpers"},
        "injected": dict(base, batches=[dict(batch, draws=slice_["draws"],
                                             neg_idx=slice_["neg_idx"])]),
        "drawn": dict(base, batches=[batch], seed=11),
        "fsdp": dict(base, batches=[batch], fsdp=True, ckpt=str(tmp / "fsdp")),
        "replicated": dict(base, batches=[batch], ckpt=str(tmp / "replicated")),
        "fsdp_init": dict(base, batches=[batch], steps=0, fsdp=True, ckpt=str(tmp / "fsdp0")),
        "replicated_init": dict(base, batches=[batch], steps=0, ckpt=str(tmp / "rep0")),
    }
    jobs["drawn_am"] = dict(base, batches=[batch], seed=11,
                            kwargs={"pretrain_masks": ("am", "rm")})
    stack_cfg = dataclasses.replace(tm.config, txt_backbone_embed_only=False)
    stack = dict(base, config=stack_cfg, batches=[batch],
                 state_dict=VioletPretrain(stack_cfg, device="cpu", seed=3).state_dict())
    jobs["fsdp_text_stack"] = dict(stack, fsdp=True)
    jobs["replicated_text_stack"] = stack
    rs = np.random.RandomState(7)
    jobs["batch_norm"] = {"kind": "batch_norm",
                          "x": torch.from_numpy(rs.randn(4, 8, 8, 16).astype(np.float32)),
                          "w": torch.from_numpy(rs.randn(4, 4, 4, 32).astype(np.float32))}
    jobs["cli"] = {"kind": "cli", "config": _pretrain_config(tmp), "grad_accum": 2}
    rm = VioletRetrieval(model_cfg(tcfg), device="cpu", seed=2)
    items, gt = _eval_items()
    jobs["two_stage"] = dict(kind="two_stage", model="retrieval", config=rm.config,
                             state_dict=rm.state_dict(), items=items, gt=gt, chunk_size=4,
                             encode_batch=2)
    outs = run_ranks(list(jobs.values()), tmp)
    two = [dict(zip(jobs, out)) for out in outs]
    one = {name: train(jobs[name], None) for name in ("injected", "drawn", "drawn_am")}
    one["batch_norm"] = batch_norm(jobs["batch_norm"], None)
    one["two_stage"] = two_stage(jobs["two_stage"], None)
    return two, one


def test_per_rank_batch_rejects_a_batch_that_does_not_divide():
    """(JAX ``tests/test_mesh.py:17-32``) A batch that divides gives each
    rank its share; one that does not, or is smaller than the rank count,
    raises rather than idling cards."""
    assert mesh.per_rank_batch(16, 8) == 2 and mesh.per_rank_batch(24, 8) == 3
    assert mesh.per_rank_batch(20, 1) == 20 and mesh.per_rank_batch(20, 4) == 5
    for bad, world in ((9, 8), (20, 8), (12, 8), (6, 8), (3, 2)):
        with pytest.raises(ValueError, match="does not divide"):
            mesh.per_rank_batch(bad, world)


def test_shard_batch_keeps_the_rows_of_the_loader_split():
    batch = {"x": torch.arange(12).reshape(6, 2), "s": torch.tensor(3.0), "ids": ["a"] * 6}
    got = mesh.shard_batch(batch, mesh.DataParallel(1, 3))
    assert torch.equal(got["x"], batch["x"][[1, 4]])
    assert got["s"] is batch["s"] and got["ids"] is batch["ids"]
    assert mesh.shard_batch(batch, None) is batch


def test_helpers_gather_in_global_order_and_metrics_of_uneven_lengths(runs):
    """``all_gather_metrics`` with lists of 1 and 2 values; ``gather_rows``
    puts rank r's row i at global row 2 i + r on both ranks, and the
    gradient of a sum over the gathered rows that each rank computes
    reaches each row once per rank."""
    two, _ = runs
    x = [torch.arange(6.0).reshape(3, 2) + 10 * r for r in range(2)]
    want = torch.stack(x, dim=1).reshape(6, 2)
    weights = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    for r in range(2):
        out = two[r]["helpers"]
        assert out["metrics"] == [0.0, 1.0, 1.0]
        assert torch.equal(out["gathered"], want)
        assert torch.equal(out["grad"], 2 * weights[r::2])


def test_pretrain_step_at_two_ranks_matches_one_process(runs):
    """Injected draws, and the step's own draws (the mask generator drawn
    at the global batch's shape, each rank keeping its rows): losses,
    step-0 gradients and parameters after two steps; both ranks hold the
    same parameters."""
    two, one = runs
    for name in ("injected", "drawn"):
        got, want = two[0][name], one[name]
        for lg, lw in zip(got["losses"], want["losses"]):
            assert set(lg) == {"mtm", "vtm", "mvm_pixel", "total"}
            for k in lw:
                np.testing.assert_allclose(lg[k], lw[k], err_msg=(name, k), **RANK_LOSS)
        assert_grads_close(got["grads0"], want["grads0"], name)
        assert_steps_close(got["params"], want["params"], want["grads0"], got["grads0"], name)
        for n, p in got["params"].items():
            assert torch.equal(p, two[1][name]["params"][n]), (name, n)


def test_am_draws_at_two_ranks_match_one_process(runs):
    """The pixel step with ("am", "rm") masking and its own draws: each
    rank runs the rollout of its rows and keeps its rows of the Gumbel
    noise drawn at the global shape, so two ranks draw what one process
    draws; losses within ``RANK_LOSS_TEMP``, step-0 gradients and
    parameters as above."""
    two, one = runs
    got, want = two[0]["drawn_am"], one["drawn_am"]
    for lg, lw in zip(got["losses"], want["losses"]):
        for k in lw:
            np.testing.assert_allclose(lg[k], lw[k], err_msg=k, **RANK_LOSS_TEMP)
    assert_grads_close(got["grads0"], want["grads0"], "drawn_am")
    assert_steps_close(got["params"], want["params"], want["grads0"], got["grads0"], "drawn_am")
    assert got["losses"] != two[0]["drawn"]["losses"]


def test_synced_batch_norm_at_two_ranks_matches_one_process(runs):
    """A bottleneck block with train-mode BatchNorm (``r50_train_bn``) on 2
    rows a rank: each rank normalizes by the global batch's statistics (the
    all-reduced sum, then the all-reduced centred squares, differentiable),
    so the two ranks give one process's 4-row block: each rank's output
    rows, the input's gradient rows and the parameters' summed gradients
    within 1e-5 of their tensor's largest value (sums in another order;
    plus 1e-6 of the largest gradient anywhere for the biases before a
    train-mode BatchNorm, whose gradient is zero in exact arithmetic), and
    each BatchNorm's batch mean and unbiased variance, the same bits on
    both ranks."""
    two, one = runs
    want = one["batch_norm"]
    assert len(want["stats"]) == 4
    for r in range(2):
        got = two[r]["batch_norm"]
        for name in ("out", "x_grad"):
            torch.testing.assert_close(got[name], want[name][r::2], rtol=0,
                                       atol=1e-5 * want[name].abs().max().item())
        top = max(g.abs().max().item() for g in want["grads"].values())
        for n, g in want["grads"].items():
            torch.testing.assert_close(got["grads"][n], g, rtol=0,
                                       atol=1e-5 * g.abs().max().item() + 1e-6 * top)
        for n, pair in want["stats"].items():
            for a, b, c in zip(got["stats"][n], pair, two[0]["batch_norm"]["stats"][n]):
                torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * b.abs().max().item())
                assert torch.equal(a, c), n


def test_pretrain_step_at_two_ranks_matches_jax_on_a_two_device_mesh(slice_, runs):
    """The JAX ``make_pretrain_train_step`` on a 2-device mesh (the batch
    sharded on ``data``, the state replicated) from the same params with
    the same draws, against the two ranks."""
    two, _ = runs
    jm, params, tm = slice_["jm"], slice_["params"], slice_["tm"]
    tx = jopt.build_optimizer(params, lr=LR, max_iter=10)
    jmesh_2 = jmesh.make_mesh(2)
    jstep = jts.make_pretrain_train_step(jm, tx, mesh=jmesh_2, donate=False)
    jstate = jts.create_train_state(params, tx)
    jbatch = {k: jnp.asarray(v) for k, v in slice_["batch"].items()}

    def jloss(p):
        return jm.apply({"params": p}, *slice_["args"], method=jm.losses, deterministic=True,
                        rngs={"mask": jax.random.PRNGKey(1)})["total"]

    jgrads = convert.state_dict_from_flax(jax.tree.map(np.asarray, jax.jit(jax.grad(jloss))(
        params)), tm.config, HEADS)
    got = two[0]["injected"]
    for i in range(2):
        jstate, jls = jstep(jstate, jbatch, jax.random.PRNGKey(7))
        np.testing.assert_allclose(got["losses"][i]["total"], float(jls["total"]), **LOSS_TOL)
    assert len(jax.tree.leaves(jstate.params)[0].sharding.device_set) == 2
    want = convert.state_dict_from_flax(jax.tree.map(np.asarray, jstate.params), tm.config,
                                        HEADS)
    assert_steps_close(got["params"], want, jgrads, got["grads0"], "jax")


def test_fsdp_matches_replicated_with_smaller_shards_and_the_same_checkpoint(runs):
    """(JAX ``tests/test_fsdp.py:61``) FSDP at two ranks against replicated
    at two ranks: losses, parameters after two steps, each rank's shards
    smaller than the model; the checkpoint written before any step is the
    replicated one byte for byte, the one after two steps holds the FSDP
    run's whole parameters leaf for leaf, with the replicated file's keys,
    shapes and dtypes. The Adam moments are shards where the parameters
    are, and the train state written restores on every rank into a fresh
    model sharded alike: parameters, moments and step."""
    two, _ = runs
    fs, rep = two[0]["fsdp"], two[0]["replicated"]
    assert fs["sharded"] > 0 and rep["sharded"] == 0
    # (JAX test_fsdp.py (i)) parameters and their Adam moments are shards
    assert fs["sharded_moments"] == fs["sharded_params"] > 0
    assert rep["sharded_moments"] == rep["sharded_params"] == 0
    assert fs["local_numel"] < fs["numel"] == rep["local_numel"]
    assert two[1]["fsdp"]["local_numel"] < fs["numel"]
    for lf, lr_ in zip(fs["losses"], rep["losses"]):
        for k in lr_:
            np.testing.assert_allclose(lf[k], lr_[k], err_msg=k, **RANK_LOSS)
    assert_steps_close(fs["params"], rep["params"], rep["grads0"], fs["grads0"], "fsdp")
    with open(_ckpt(runs, "fsdp_init"), "rb") as a, open(_ckpt(runs, "replicated_init"), "rb") as b:
        assert a.read() == b.read()
    f_tree, r_tree = (dict(_leaves(load_tree(_ckpt(runs, k)))) for k in ("fsdp", "replicated"))
    assert set(f_tree) == set(r_tree)
    for k, v in f_tree.items():
        assert v.shape == r_tree[k].shape and v.dtype == r_tree[k].dtype, k
    for n, p in fs["loaded"].items():
        assert torch.equal(p, fs["params"][n]), n
    # every rank resumes the train state into a fresh model sharded alike
    for r in range(2):
        assert two[r]["fsdp"]["resumed_equal"] and two[r]["replicated"]["resumed_equal"], r


def test_fsdp_shards_the_text_stack_and_matches_replicated(runs):
    """With the text stack (``txt_backbone_embed_only`` false) ``shard_model``
    also shards its two layers (``fsdp_min_size`` 0), which the pretrain
    step's ``losses`` reaches through ``forward``: two steps at two ranks
    match the replicated run as the model without the stack does."""
    two, _ = runs
    fs, rep = two[0]["fsdp_text_stack"], two[0]["replicated_text_stack"]
    assert fs["sharded"] == two[0]["fsdp"]["sharded"] + 2 and rep["sharded"] == 0
    assert fs["local_numel"] < fs["numel"] == rep["local_numel"]
    for lf, lr_ in zip(fs["losses"], rep["losses"]):
        for k in lr_:
            np.testing.assert_allclose(lf[k], lr_[k], err_msg=k, **RANK_LOSS)
    assert_steps_close(fs["params"], rep["params"], rep["grads0"], fs["grads0"],
                       "fsdp text stack")


def _ckpt(runs, name):
    return runs[0][0][name]["ckpt"]


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_two_stage_eval_at_two_ranks_equals_one_process(runs):
    """(JAX ``tests/test_evaluators_mesh.py:80``) Five items, four videos:
    every rank's R@1/5/10 and MedR equal one process's exactly."""
    two, one = runs
    keys = ("r1", "r5", "r10", "medr")
    for r in range(2):
        assert {k: two[r]["two_stage"][k] for k in keys} == {k: one["two_stage"][k] for k in keys}
    assert two[0]["two_stage"]["_pairs"] == one["two_stage"]["_pairs"] == 20.0


def test_pretrain_cli_at_two_ranks_with_fsdp_remat_and_grad_accum(runs):
    """``cli.pretrain``'s main on two ranks (the process group already
    joined, as ``torch.distributed.run`` leaves it), ``fsdp`` with every
    block sharded, ``remat``, ``grad_accum`` 2: both ranks run the same
    steps in rank 0's run dir, where rank 0 wrote the final checkpoint,
    ``restore.state`` and finite val losses; the checkpoint loads into a
    one-process model, moved from its init, and the train state restores
    into it."""
    two, _ = runs
    res = [two[r]["cli"] for r in range(2)]
    # two shards of 4 videos: one batch a shard, so two micro-steps, one update
    assert res[0]["run_dir"] == res[1]["run_dir"] and res[0]["steps"] == res[1]["steps"] == 2
    assert res[0]["sharded"] == res[1]["sharded"] == 4 + 2     # swin blocks + fusion layers
    run_dir = res[0]["run_dir"]
    files = set(os.listdir(run_dir))
    final = f"ckpt_violet_pretrain_final_{res[0]['steps']}.msgpack"
    assert {final, "restore.state", "log.json", "metrics.jsonl"} <= files
    recs = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    losses = [v for r in recs for k, v in r.items() if k.startswith("val_") and "/" in k
              and not k.endswith("n_batches")]
    assert losses and np.all(np.isfinite(losses))
    run = tcfg.load_run_config(os.path.join(run_dir, "..", "..", "pretrain.json"))
    model = VioletPretrain.from_run_config(run, device="cpu", seed=run.train.seed)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    model.load_state_dict(load_params(os.path.join(run_dir, final)))
    assert any(not torch.equal(v, init[k]) for k, v in model.state_dict().items())
    opt = build_optimizer(model, dataclasses.replace(run.train, grad_accum=2), 10)
    state = load_train_state(os.path.join(run_dir, "restore.state"),
                             create_train_state(model, opt))
    assert state.step == 2 and state.opt_state["count"] == 1
