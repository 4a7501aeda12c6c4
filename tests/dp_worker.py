"""One rank of the data-parallel CPU tests: ``python -m tests.dp_worker
WORKDIR RANK WORLD``. It joins a gloo process group through the file
``WORKDIR/rendezvous`` (no port), runs the jobs of ``WORKDIR/jobs.pt`` in
order and writes ``WORKDIR/out_RANK.pt``. It imports torch and the port, and
nothing of JAX.

Each job is a dict whose ``kind`` names a function below; a job's inputs hold
the global batch, and the worker keeps its rows (``parallel.mesh.shard_batch``
and, for injected draws, the same ``[rank::world]`` rows).
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from empirical_mvm_torch.data.masking import MaskDraws
from empirical_mvm_torch.models.pretrain import VioletPretrain
from empirical_mvm_torch.models.tasks import VioletQAMC, VioletRetrieval
from empirical_mvm_torch.parallel import mesh
from empirical_mvm_torch.train import optimizer as topt
from empirical_mvm_torch.train.checkpoint import (load_params, load_train_state, save_params,
                                                  save_train_state)
from empirical_mvm_torch.train.evaluators import retrieval_two_stage_eval
from empirical_mvm_torch.train.train_step import (create_train_state, make_pretrain_train_step,
                                                  make_supervised_train_step)

MODELS = {"pretrain": VioletPretrain, "retrieval": VioletRetrieval, "qamc": VioletQAMC}


def local_batch(batch: dict, dp) -> dict:
    if dp is None:
        return batch
    out = mesh.shard_batch({k: v for k, v in batch.items() if k != "draws"}, dp)
    if batch.get("draws") is not None:
        d = batch["draws"]
        r, w = dp.rank, dp.world
        out["draws"] = MaskDraws(d.choice[r::w], d.covs[:, r::w], d.txt_sel[:, r::w])
    return out


def build(job: dict):
    model = MODELS[job["model"]](job["config"], device="cpu", seed=1, **job.get("kwargs", {}))
    model.load_state_dict(job["state_dict"])
    model.fc[0].p = 0.0
    return model


def train(job: dict, dp) -> dict:
    """``job["steps"]`` steps of the pretrain (``loss_kind`` None) or the
    supervised step, replicated or FSDP; the global losses, the whole
    parameters and the BatchNorms' running statistics after the steps, the
    local shards' element count and, given ``ckpt``, the checkpoint and
    train state written there."""
    model = build(job)
    sharded = mesh.shard_model(model, dp, job.get("fsdp", False), job.get("fsdp_min_size", 0))
    opt = topt.AdamW(model, job.get("lr", 1e-3), 10, grad_accum=job.get("grad_accum", 1))
    state = create_train_state(model, opt)
    if job.get("loss_kind") is None:
        step = make_pretrain_train_step(model, opt, dp)
    else:
        step = make_supervised_train_step(model, opt, job["loss_kind"], job.get("temp", 0.05), dp)
    batches = job["batches"]
    losses, grads0 = [], {}
    for i in range(job["steps"]):
        state, ls = step(state, local_batch(batches[i % len(batches)], dp), job.get("seed", 7))
        losses.append({k: float(v) for k, v in ls.items()})
        if i == 0:
            grads0 = {n: (torch.zeros(p.shape) if p.grad is None
                          else mesh.full_tensor(p.grad).clone())
                      for n, p in model.named_parameters()}
    out = {"losses": losses, "grads0": grads0,
           "params": {n: mesh.full_tensor(p.detach()).clone()
                      for n, p in model.named_parameters()},
           "buffers": {n: b.clone() for n, b in state.buffers.items()},
           "local_numel": sum(mesh.local_tensor(p).numel() for p in model.parameters()),
           "sharded_params": sum(mesh.local_tensor(p) is not p for p in model.parameters()),
           "sharded_moments": sum(mesh.local_tensor(m) is not m
                                  for m in state.opt_state["mu"].values()),
           "numel": sum(p.numel() for p in model.parameters()),
           "sharded": len(sharded)}
    if job.get("ckpt"):
        save_params(model, job["ckpt"] + ".msgpack")
        save_train_state(state, job["ckpt"] + ".state")
        mesh.barrier()
        out["loaded"] = load_params(job["ckpt"] + ".msgpack")
        out["ckpt"] = job["ckpt"] + ".msgpack"
        out["resumed_equal"] = resumes(job, dp, state)
    return out


def resumes(job: dict, dp, state) -> bool:
    """Whether the train state just written restores, into a fresh model
    sharded as this one, to the same parameters, moments and step."""
    model = build(job)
    mesh.shard_model(model, dp, job.get("fsdp", False), job.get("fsdp_min_size", 0))
    opt = topt.AdamW(model, job.get("lr", 1e-3), 10, grad_accum=job.get("grad_accum", 1))
    back = load_train_state(job["ckpt"] + ".state", create_train_state(model, opt))

    def same(a, b):
        return torch.equal(mesh.full_tensor(a.detach()), mesh.full_tensor(b.detach()))

    # every gather runs on every rank, in the same order (no short circuit)
    equal = [same(back.params[n], p) for n, p in state.params.items()]
    equal += [same(back.opt_state[k][n], m) for k in ("mu", "nu")
              for n, m in state.opt_state[k].items()]
    return (all(equal) and back.step == state.step
            and back.opt_state["count"] == state.opt_state["count"])


class _Items:
    """A two-stage eval dataset over prepared items."""

    def __init__(self, items, gt):
        self.items, self.gt_txt2vid = items, gt

    def __len__(self):
        return len(self.items)

    def multi_clip_item(self, i):
        return self.items[i]


def two_stage(job: dict, dp) -> dict:
    model = build(job)
    return retrieval_two_stage_eval(model, _Items(job["items"], job["gt"]),
                                    chunk_size=job["chunk_size"],
                                    encode_batch=job["encode_batch"], device="cpu", dp=dp)


def helpers(job: dict, dp) -> dict:
    """The mesh helpers: uneven metric lists, and the gather in global order
    with its gradient."""
    metrics = mesh.all_gather_metrics([float(dp.rank)] * (dp.rank + 1))
    x = (torch.arange(6.0).reshape(3, 2) + 10 * dp.rank).requires_grad_(True)
    with mesh.data_parallel(dp):
        g = mesh.gather_rows(x)
        weights = torch.arange(g.numel(), dtype=torch.float32).reshape(g.shape)
        (g * weights).sum().backward()
    return {"metrics": metrics, "gathered": g.detach(), "grad": x.grad}


def cli(job, dp) -> dict:
    """``cli.pretrain``'s main on this rank, on the CPU with frames decoded
    by cv2, ``grad_accum`` set to ``job["grad_accum"]`` (no task file sets
    it); the run, and the blocks FSDP sharded."""
    import cv2
    from unittest import mock

    from empirical_mvm_torch.cli import common, pretrain
    from empirical_mvm_torch.train import agent

    def decode(data):
        a = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        return None if a is None else a[:, :, ::-1]

    sharded, parse = [], common.parse_cli

    def shard(*args, **kwargs):
        units = mesh.shard_model(*args, **kwargs)
        sharded.extend(units)
        return units

    def parse_accum(*args, **kwargs):
        cfg = parse(*args, **kwargs)
        return dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, grad_accum=job["grad_accum"]))

    with mock.patch.object(agent, "shard_model", shard), \
            mock.patch.object(common, "parse_cli", parse_accum):
        res = pretrain.main(["--config", job["config"]], device="cpu", decode=decode)
    return {"run_dir": res["run_dir"], "steps": res["steps"], "sharded": len(sharded)}


def batch_norm(job: dict, dp) -> dict:
    """A ``BottleneckBlock`` (4 train-mode BatchNorms, one on the projected
    shortcut) on this rank's rows of ``job["x"]``: the output rows, the
    weighted sum's gradients (the parameters' summed over the ranks, as the
    train steps reduce them; the input's), and each BatchNorm's batch
    statistics, which every rank computes over the global batch."""
    from empirical_mvm_torch.models.common import BatchNorm2d
    from empirical_mvm_torch.models.encoders2d import BottleneckBlock
    torch.manual_seed(0)
    block = BottleneckBlock(job["x"].shape[-1], 8, stride=2, project=True)
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, BatchNorm2d):
                m.bias.add_(3.0)
    x = job["x"] if dp is None else job["x"][dp.rank::dp.world]
    x = x.clone().requires_grad_(True)
    with mesh.data_parallel(dp):
        out = block(x, use_batch_stats=True)
    w = job["w"] if dp is None else job["w"][dp.rank::dp.world]
    (out * w).sum().backward()
    mesh.reduce_gradients(list(block.parameters()), dp)
    return {"out": out.detach(), "x_grad": x.grad,
            "grads": {n: p.grad for n, p in block.named_parameters()},
            "stats": {n: m.batch_stats for n, m in block.named_modules()
                      if isinstance(m, BatchNorm2d)}}


JOBS = {"train": train, "two_stage": two_stage, "helpers": helpers, "cli": cli,
        "batch_norm": batch_norm}


def main(workdir: str, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous",
                            rank=rank, world_size=world)
    try:
        dp = mesh.DataParallel(rank, world)
        jobs = torch.load(os.path.join(workdir, "jobs.pt"), weights_only=False)
        outs = [JOBS[job["kind"]](job, dp) for job in jobs]
        torch.save(outs, os.path.join(workdir, f"out_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(jobs: list[dict], workdir, world: int = 2, timeout: float = 300) -> list[list]:
    """Run ``jobs`` on ``world`` worker processes in a new directory under
    ``workdir`` (a rendezvous file is good for one group only); returns each
    rank's outputs. A rank that fails fails the call with its output."""
    workdir = tempfile.mkdtemp(dir=str(workdir))
    torch.save(jobs, os.path.join(workdir, "jobs.pt"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "tests.dp_worker", workdir, str(r),
                               str(world)], cwd=os.path.dirname(os.path.dirname(__file__)),
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited with {p.returncode}:\n{logs[r][-4000:]}")
    return [torch.load(os.path.join(workdir, f"out_{r}.pt"), weights_only=False)
            for r in range(world)]


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
