"""The run loop (counterpart of ``empirical_mvm_tpu/train/agent.py`` and of
``CaptionAgent`` in ``cli/caption.py``; ref: agent.py:52-211,
main_retrieval.py:87-124, main_qamc.py:105-183, main_pretrain.py:269-619):
epochs with the zero-shot eval first, the EMA loss meters, the logging
cadence, checkpoints each epoch by the main process, best-epoch tracking,
the resumable state and the profiler window, on one card or, in a process
group that ``torch.distributed.run`` started, on one card a rank.

An agent owns the model (its parameters are the train state's), the
optimizer of ``train/optimizer.build_optimizer`` and its step
(``train/train_step.py``). Batches come through ``data/loader.py``
``DevicePrefetcher`` (nvJPEG on the card; on the CPU the caller's
``decode``). A step's losses stay device tensors until a logging step
drains them into the meters, in order, so the loop never waits for the card
between logging steps.

Across ranks (``parallel/mesh.py``), ``train.size_batch`` is the global
batch and each rank's loaders give it ``size_batch / W`` rows; the model's
parameters are replicated or, with ``train.fsdp``, its blocks sharded, before
the optimizer is built; the steps reduce over the ranks, so the losses every
rank logs are the global ones and every rank holds the same state. Rank 0
writes checkpoints, logs and the profile; the others wait at a barrier
after each write.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from collections import defaultdict
from typing import Callable, Iterable

import numpy as np
import torch

from empirical_mvm_torch.core.config import RunConfig
from empirical_mvm_torch.core.tracing import profiler, write_trace
from empirical_mvm_torch.data.loader import DevicePrefetcher
from empirical_mvm_torch.parallel.mesh import (barrier, data_parallel, default_data_parallel,
                                               is_main_process, pad_batch, per_rank_batch,
                                               reduce_losses, shard_model)
from empirical_mvm_torch.train.checkpoint import (load_train_state, save_params,
                                                  save_train_state)
from empirical_mvm_torch.train.metrics import MetricsLogger
from empirical_mvm_torch.train.optimizer import build_optimizer
from empirical_mvm_torch.train.train_step import (create_train_state, make_eval_step,
                                                  make_pretrain_train_step,
                                                  make_supervised_train_step)

logger = logging.getLogger(__name__)


class RunningMeter:
    """EMA loss meter, smooth=0.99 (ref: utils/logger.py:164-186)."""

    def __init__(self, smooth: float = 0.99):
        self.smooth = smooth
        self._val: float | None = None

    def update(self, v: float) -> None:
        if math.isnan(v) or math.isinf(v):
            return
        self._val = v if self._val is None else self.smooth * self._val + (1 - self.smooth) * v

    @property
    def val(self) -> float:
        return float("nan") if self._val is None else self._val


def device_batch(batch: dict) -> dict:
    """The tensors of a materialized batch (ids and raw strings left out)."""
    return {k: v for k, v in batch.items() if isinstance(v, torch.Tensor)}


class AgentBase:
    """(ref: agent.py:52-211) ``device`` is the card unless the caller asks
    for the CPU, which needs ``decode`` (``data/jpeg.py`` ``frame_decoder``)."""

    # profile steps [PROFILE_FROM, PROFILE_FROM + train.profile_n_steps)
    PROFILE_FROM = 3    # past the first launches and the allocator's warm-up

    def __init__(self, run_cfg: RunConfig, model, *, device="cuda", decode=None,
                 max_iter: int | None = None):
        self.cfg = run_cfg
        self.model = model
        tc = run_cfg.train
        self.device = torch.device(device)
        self.decode = decode
        self.max_iter = max_iter or max(tc.max_iter, 1)
        self.dp = default_data_parallel()
        self.local_batch = per_rank_batch(tc.size_batch, 1 if self.dp is None else self.dp.world)
        self.sharded = shard_model(model, self.dp, tc.fsdp, tc.fsdp_min_size)
        self.opt = build_optimizer(model, tc, self.max_iter)
        self.state = create_train_state(model, self.opt)
        self.seed = tc.seed
        self.global_step = 0
        self.meters: dict[str, RunningMeter] = defaultdict(RunningMeter)
        self.log: dict[str, list] = defaultdict(list)
        self.metrics = MetricsLogger(run_cfg.path_output, run_cfg.task) \
            if is_main_process() else None
        self._profiler = None
        self._build_steps()

    def _build_steps(self):
        """Subclasses install ``self.train_step`` and their eval."""
        raise NotImplementedError

    def batches(self, loader: Iterable) -> DevicePrefetcher:
        return DevicePrefetcher(loader, self.device, self.decode)

    # ---- loops ----

    def _maybe_profile_start(self) -> None:
        if (self.cfg.train.profile_n_steps > 0 and self._profiler is None and is_main_process()
                and self.global_step == self.PROFILE_FROM):
            self._profiler = profiler(self.device)
            self._profiler.start()

    def _maybe_profile_stop(self) -> None:
        if (self._profiler is not None
                and self.global_step >= self.PROFILE_FROM + self.cfg.train.profile_n_steps):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)     # the window's kernels, all of them
            self._profiler.stop()
            write_trace(self._profiler, os.path.join(self.cfg.path_output, "profile"))
            self._profiler = None

    def _step(self, batch: dict) -> dict:
        self._maybe_profile_start()
        self.state, ls = self.train_step(self.state, device_batch(batch), self.seed)
        self.global_step += 1
        self._maybe_profile_stop()
        return ls

    def _log_train(self, prefix: str) -> None:
        vals = {k: round(m.val, 4) for k, m in self.meters.items()}
        logger.info("%sstep %d %s", prefix, self.global_step, vals)
        if self.metrics is not None:
            self.metrics.log({f"train_{k}": v for k, v in vals.items()}, self.global_step)

    def train_epoch(self, loader: Iterable, epoch: int) -> dict[str, float]:
        t_start = time.time()
        n = 0
        pending: list[dict] = []    # device losses, drained at the logging steps
        for _tag, batch in self.batches(loader):
            pending.append(self._step(batch))
            n += 1
            if n % self.cfg.train.logging_steps == 0:
                self._drain_meters(pending)
                self._log_train(f"ep {epoch} ")
        self._drain_meters(pending)
        dt = time.time() - t_start
        out = {k: m.val for k, m in self.meters.items()}
        out["steps_per_sec"] = n / max(dt, 1e-9)
        return out

    def _drain_meters(self, pending: list[dict], prefix: str = "") -> None:
        for ls in pending:
            for k, v in ls.items():
                self.meters[prefix + k].update(float(v))
        pending.clear()

    def eval_batches(self, loader: Iterable):
        """Yield (batch, device batch, n_valid): each tail batch padded to
        the rank's share of the training batch, as the JAX eval's one
        compiled shape."""
        for _tag, batch in self.batches(loader):
            db, n_valid = pad_batch(device_batch(batch), self.local_batch)
            yield batch, db, n_valid

    def save(self, epoch: int, tag: str | None = None) -> None:
        """(ref: agent.py:134-141) Every rank calls it (a sharded model is
        gathered); rank 0 writes."""
        tag = tag or self.cfg.task
        path = os.path.join(self.cfg.path_output, f"ckpt_violet_{tag}_{epoch}.msgpack")
        save_params(self.model, path, meta={"epoch": epoch, "step": self.global_step,
                                            "task": self.cfg.task})
        if is_main_process():
            with open(os.path.join(self.cfg.path_output, "log.json"), "w") as f:
                json.dump({k: v for k, v in self.log.items()}, f, indent=2, default=float)
            logger.info("saved %s", path)
        barrier()

    def save_resumable(self, tag: str = "restore") -> None:
        """Full-resume checkpoint with the optimizer state (double-buffered);
        every rank calls it, rank 0 writes."""
        save_train_state(self.state, os.path.join(self.cfg.path_output, f"{tag}.state"),
                         meta={"step": self.global_step, "task": self.cfg.task})
        barrier()

    def resume(self, tag: str = "restore") -> bool:
        """Restore parameters, optimizer and step if a resume checkpoint
        exists; every rank reads the same file."""
        path = os.path.join(self.cfg.path_output, f"{tag}.state")
        if not (os.path.exists(path) or os.path.exists(path + ".backup")):
            return False
        self.state = load_train_state(path, self.state)
        self.global_step = int(self.state.step)
        logger.info("resumed from %s at step %d", path, self.global_step)
        return True

    def fit(self, dl_tr, dl_vl=None, dl_ts=None, eval_fn: Callable | None = None) -> None:
        """Epochs with the zero-shot eval first and best tracking (ref:
        main_qamc_tsv_mlm_gen_ans_idx.py:158-185). ``eval_fn(loader)``
        evaluates the model as it stands."""
        if eval_fn is not None:
            zs = {s: eval_fn(dl) for s, dl in (("vl", dl_vl), ("ts", dl_ts)) if dl is not None}
            logger.info("zero-shot: %s", zs)
        for ep in range(1, self.cfg.train.size_epoch + 1):
            if hasattr(dl_tr, "set_epoch"):
                dl_tr.set_epoch(ep)
            self.log["ls_tr"].append(self.train_epoch(dl_tr, ep))
            if eval_fn is not None:
                for s, dl in (("vl", dl_vl), ("ts", dl_ts)):
                    if dl is not None:
                        self.log[f"ac_{s}"].append(eval_fn(dl))
            logger.info("ep %d done: %s", ep, {k: v[-1] for k, v in self.log.items() if v})
            self.save(ep)

    def best_epoch(self) -> tuple[tuple[int, float], tuple[int, float]]:
        """(ref: agent.py:203-210)"""
        vl = [m if np.isscalar(m) else list(m.values())[0] for m in self.log["ac_vl"]]
        ts = [m if np.isscalar(m) else list(m.values())[0] for m in self.log["ac_ts"]]
        iv, it = int(np.argmax(vl)), int(np.argmax(ts))
        return (iv, vl[iv]), (it, ts[it])


class PretrainAgent(AgentBase):
    """(ref: Agent_Pretrain at main_pretrain.py:269-610)"""

    def _build_steps(self):
        self.train_step = make_pretrain_train_step(self.model, self.opt, self.dp)

    def make_val_fn(self, val_loaders: dict[str, Iterable], max_batches: int = 16) -> Callable:
        """Validation losses over the val loaders (ref:
        main_pretrain_yaml.py:106-149 ``evaluate``, at startup and every
        eval step). Deterministic: no dropout, and every batch masked from
        a generator seeded from ``seed + 1`` (the JAX fixed key), so each
        eval masks the same tokens and patches. Tail batches are padded to
        the train batch size. At most ``max_batches`` a loader; the count
        is logged beside the means. Across ranks, the losses of the global
        batch."""
        model, b, seed = self.model, self.local_batch, self.cfg.train.seed + 1

        @torch.no_grad()
        def eval_fn():
            out: dict[str, float] = {}
            for name, dl in val_loaders.items():
                sums: dict[str, float] = defaultdict(float)
                cnt = 0
                it = iter(self.batches(dl))
                try:
                    for _tag, batch in it:
                        if cnt == max_batches:
                            break
                        db, _ = pad_batch(device_batch(batch), b)
                        with data_parallel(self.dp):
                            ls = model.losses(
                                db["img"], db["txt"], db["mask"],
                                mask_generator=torch.Generator(self.device).manual_seed(seed),
                                vq=db.get("vq"), hog=db.get("hog"), corrupt=db.get("corrupt"))
                        ls = reduce_losses(ls, self.dp)
                        for k, v in ls.items():
                            sums[k] += float(v)
                        cnt += 1
                finally:
                    it.close()
                for k, s in sums.items():
                    out[f"{name}/{k}"] = s / max(cnt, 1)
                out[f"{name}/n_batches"] = float(cnt)
            return out

        return eval_fn

    def _log_eval(self, results: dict[str, float]) -> None:
        logger.info("val @%d: %s", self.global_step, {k: round(v, 4) for k, v in results.items()})
        if self.metrics is not None:
            self.metrics.log({f"val_{k}": v for k, v in results.items()}, self.global_step)

    def run_meta(self, meta_loader, num_steps: int, eval_every: int = 0,
                 eval_fn: Callable | None = None) -> None:
        """``MetaLoader``-driven pretraining (ref: main_pretrain_yaml.py:151-194):
        the val losses at startup and every ``eval_every`` steps, each
        followed by a checkpoint and the resumable state."""
        if eval_fn is not None:
            self._log_eval(eval_fn())       # zero-shot
        pending: list[tuple[str, dict]] = []
        it = iter(self.batches(meta_loader))
        try:
            for _ in range(num_steps):
                task, batch = next(it)
                pending.append((task, self._step(batch)))
                if self.global_step % self.cfg.train.logging_steps == 0:
                    for t, ls in pending:
                        self._drain_meters([ls], prefix=f"{t}/")
                    pending.clear()
                    self._log_train("")
                if eval_every and self.global_step % eval_every == 0:
                    if eval_fn is not None:
                        self._log_eval(eval_fn())
                    self.save(self.global_step, tag="pretrain")
                    self.save_resumable()
        finally:
            it.close()
        for t, ls in pending:
            self._drain_meters([ls], prefix=f"{t}/")


def make_supervised_agent(loss_kind: str):
    """Agent of the downstream heads: ``ce`` (logits (B, K) against
    ``ans``), ``mlm`` (against ``mask_ans``), ``nce`` (the (B, B) scores,
    NormSoftmaxLoss at ``train.temp``), on ``make_supervised_train_step``;
    ``eval_forward(batch)`` is the deterministic forward."""

    class SupervisedAgent(AgentBase):
        def _build_steps(self):
            self.train_step = make_supervised_train_step(self.model, self.opt, loss_kind,
                                                         self.cfg.train.temp, self.dp)
            self.eval_forward = make_eval_step(self.model, self.dp)

    SupervisedAgent.__name__ = f"SupervisedAgent_{loss_kind}"
    return SupervisedAgent


RetrievalAgent = make_supervised_agent("nce")
QAMCAgent = make_supervised_agent("ce")
QAMCGenAgent = make_supervised_agent("mlm")
QAOEAgent = make_supervised_agent("ce")
QAOEMLMAgent = make_supervised_agent("mlm")


class CaptionAgent(AgentBase):
    """(JAX ``cli/caption.py:61``) The label-smoothed caption step;
    ``generate(img)`` decodes 20 tokens with the re-encoding ``generate``
    (``data.decode``), or ``generate_beam`` when ``data.num_beams > 1``."""

    def _build_steps(self):
        self.train_step = make_supervised_train_step(self.model, self.opt, "caption",
                                                     dp=self.dp)

    @torch.no_grad()
    def generate(self, img: torch.Tensor) -> torch.Tensor:
        nb = self.cfg.data.num_beams
        if nb > 1:
            return self.model.generate_beam(img, 20, beam_size=nb)
        return self.model.generate(img, 20, decode=self.cfg.data.decode)
