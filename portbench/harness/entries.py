"""The entries of the program a cell drives, one class each, chosen by the traffic file's
``entry``: the pretrain step (``pretrain_step``) and the two-stage retrieval
eval (``retrieval_eval``).

An entry builds the program's objects from the configuration file, loads
the benchmark's seeded weights, warms up (for a train step: the first
``check_steps`` steps, whose readings the correctness check keeps), then
runs the closed loop of the measured window: each step or eval starts when
the previous one has ended. It hands what the program produced to
``check.py`` and can free the program before the reference runs.
"""

from __future__ import annotations

import contextlib
import gc
import math
import time

import torch

from portbench.harness import inputs, work


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Entry:
    """What every entry shares: the cell, its seed, the device and the
    program's run configuration."""

    def __init__(self, cell, seed: int, device: torch.device):
        from empirical_mvm_torch.core.config import load_run_config
        self.cell, self.seed, self.device = cell, seed, device
        self.traffic, self.config = cell.traffic, cell.config
        self.run_cfg = load_run_config(dict(cell.config["run"]))
        self.dims = cell.config["dims"]
        self.dtype = getattr(torch, cell.config["dtype"])
        self.checks: dict = {}
        self.split: list[tuple[str, float]] = []
        self._mark_t = time.perf_counter()

    def mark(self, phase: str) -> None:
        """End a phase of set-up: its seconds, the device's queued work
        included, go to ``split``."""
        _sync(self.device)
        now = time.perf_counter()
        self.split.append((phase, now - self._mark_t))
        self._mark_t = now

    def _weights(self, model):
        return inputs.make_weights(inputs.param_specs(model), self.seed, self.device)

    def release(self):
        """Drop the program's objects and cached blocks."""
        for name in list(vars(self)):
            if name not in ("cell", "seed", "device", "traffic", "config", "run_cfg", "dims",
                            "dtype", "checks", "split"):
                delattr(self, name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class PretrainEntry(Entry):
    """The pretrain step fed from a pool of seeded batches, cycled."""

    kind = "train"

    def setup(self):
        from empirical_mvm_torch.models.pretrain import VioletPretrain
        from empirical_mvm_torch.train.optimizer import build_optimizer
        from empirical_mvm_torch.train.train_step import (create_train_state,
                                                          make_pretrain_train_step)
        self.mark("program imports")
        t = self.traffic
        m = self.run_cfg.model
        self.batch_size = t["batch"]
        self.pool = inputs.train_pool(self.seed, t["pool"], t["batch"], m.size_frame,
                                      m.size_img, m.size_txt, m.text.vocab_size, self.device)
        self.mark("inputs")
        self.model = VioletPretrain.from_run_config(self.run_cfg, dtype=self.dtype,
                                                    device=self.device)
        self.mark("model")
        weights = self._weights(self.model)
        inputs.load_weights(self.model, weights)
        self.mark("weights")
        self.opt = build_optimizer(self.model, self.run_cfg.train, self.config["assumed"]["max_iter"])
        self.state = create_train_state(self.model, self.opt)
        self.step = make_pretrain_train_step(self.model, self.opt)
        self.mark("optimizer")
        self.next_batch = 0
        # the first steps warm every shape up; their readings are kept
        losses = []
        for i in range(t["check_steps"]):
            if i == 0:
                with self.keep_vtm_scores():
                    ls = self.one_step()
            else:
                ls = self.one_step()
            losses.append({k: float(v) for k, v in ls.items()})
            if i == 0:
                b1 = self.opt.betas[0]
                mu = self.state.opt_state["mu"]
                names = sorted(mu)
                norms = torch.stack(torch._foreach_norm([mu[n] for n in names])) / (1.0 - b1)
                self.checks["first_grad"] = dict(zip(names, norms.tolist()))
        params = self.state.params
        names = sorted(n for n in params if n in self.state.opt_state["mu"])
        deltas = torch.stack(torch._foreach_norm(
            [params[n].detach() - weights[n] for n in names]))
        self.checks["delta"] = dict(zip(names, deltas.tolist()))
        self.checks["losses"] = losses
        del weights
        self.mark("warm-up steps")

    @contextlib.contextmanager
    def keep_vtm_scores(self):
        """The VTM score head's outputs of one step (its positive rows, then
        its negative rows), kept by a forward hook that is gone before the
        window."""
        kept = []
        handle = self.model.fc.register_forward_hook(
            lambda module, args, out: kept.append(out.detach().float().reshape(-1).clone()))
        try:
            yield
        finally:
            handle.remove()
        self.checks["scores"] = torch.cat(kept)

    def one_step(self):
        batch = self.pool[self.next_batch % len(self.pool)]
        self.next_batch += 1
        self.state, ls = self.step(self.state, batch, self.seed)
        return ls

    def window(self, seconds: float) -> dict:
        """Back-to-back steps until ``seconds`` have passed, each ended by a
        device synchronise; all of them and all their time count."""
        step_s, failed = [], 0
        _sync(self.device)
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            ls = self.one_step()
            _sync(self.device)
            b = time.perf_counter()
            step_s.append(b - a)
            failed += not math.isfinite(float(ls["total"]))
            if b - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        return {"kind": self.kind, "steps": len(step_s), "step_s": step_s,
                "clips": len(step_s) * self.batch_size, "seconds": elapsed,
                "attempted": len(step_s), "failed": failed,
                "flops": self.step_flops() * len(step_s)}

    def traced_work(self):
        for _ in range(self.traffic["trace_steps"]):
            self.one_step()
        _sync(self.device)

    def trace_work_count(self) -> dict:
        return {"steps": self.traffic["trace_steps"]}

    def gap_work(self):
        for _ in range(2):
            self.one_step()
        _sync(self.device)

    def step_flops(self) -> float:
        return work.pretrain_step_flops(self.dims, self.config["run"], self.batch_size)

    def window_attention_calls(self, steps: int):
        m = self.run_cfg.model
        return steps * work.window_attention_calls(self.dims["swin"], self.batch_size,
                                                   m.size_frame, m.size_img, backward=True)

    def fusion_attention_calls(self, steps: int):
        m = self.run_cfg.model
        rows = self.batch_size * 4
        length = work.video_tokens(self.dims, m.size_frame, m.size_img) + m.size_txt
        return steps * work.self_attention_calls(self.dims["fusion"], rows, length, True)

    def teacher_ms(self) -> float | None:
        """Device ms of one no-grad call of the frozen teacher on the
        normalized clips of one batch (CUDA events)."""
        from empirical_mvm_torch.ops.preprocess import maybe_normalize
        img = maybe_normalize(self.pool[0]["img"])
        with torch.no_grad():
            self.model.feature_model(img)                  # the same shapes as the step's
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            self.model.feature_model(img)
            end.record()
            torch.cuda.synchronize(self.device)
        return start.elapsed_time(end)


class Recorder:
    """The retrieval model as the evaluator sees it: every call goes to the
    model, and the outputs of ``encode`` and ``score_pairs`` are kept (by
    reference, no copy) for the correctness check."""

    def __init__(self, model):
        self.model = model
        self.enc, self.scores = [], []

    def reset(self):
        self.enc, self.scores = [], []

    def encode(self, *args):
        out = self.model.encode(*args)
        self.enc.append(out[0])
        return out

    def score_pairs(self, *args):
        out = self.model.score_pairs(*args)
        self.scores.append(out)
        return out


class RetrievalEvalEntry(Entry):
    """Whole two-stage evals over one seeded item set, back to back."""

    kind = "eval"

    def setup(self):
        from empirical_mvm_torch.models.tasks import VioletRetrieval
        from empirical_mvm_torch.train.evaluators import retrieval_two_stage_eval  # noqa: F401
        self.mark("program imports")
        t, m = self.traffic, self.run_cfg.model
        self.items = inputs.RetrievalItems(self.seed, t["captions"], t["clips"], m.size_frame,
                                           m.size_img, m.size_txt, m.text.vocab_size,
                                           self.device)
        self.mark("inputs")
        self.model = VioletRetrieval(m, dtype=self.dtype, device=self.device)
        self.mark("model")
        inputs.load_weights(self.model, self._weights(self.model))
        self.model.eval()
        self.recorder = Recorder(self.model)
        self.mark("weights")
        for _ in range(t["warmup_evals"]):
            self.one_eval()
        self.mark("warm-up evals")

    def one_eval(self) -> dict:
        from empirical_mvm_torch.train.evaluators import retrieval_two_stage_eval
        t = self.traffic
        self.recorder.reset()
        return retrieval_two_stage_eval(self.recorder, self.items, chunk_size=t["chunk_size"],
                                        encode_batch=t["encode_batch"], device=self.device)

    def window(self, seconds: float) -> dict:
        """Whole evals until ``seconds`` have passed; the pairs of every eval
        over the seconds from the window's start to the end of the last."""
        counts = dict(evals=0, stage1_s=0.0, stage2_s=0.0, clips=0.0, pairs=0.0)
        failed = 0
        _sync(self.device)
        t0 = time.perf_counter()
        while True:
            out = self.one_eval()
            counts["evals"] += 1
            for k in ("stage1_s", "stage2_s", "clips", "pairs"):
                counts[k] += out[f"_{k}"]
            failed += not bool(torch.isfinite(torch.cat(self.recorder.scores)).all())
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        return {"kind": self.kind, "seconds": elapsed, "attempted": counts["evals"],
                "failed": failed, "flops": self.eval_flops() * counts["evals"], **counts}

    def n_pairs(self) -> int:
        return self.traffic["captions"] * self.traffic["captions"]

    def eval_flops(self) -> float:
        m = self.run_cfg.model
        return work.retrieval_eval_flops(self.dims, self.traffic["captions"] * self.traffic["clips"],
                                         self.n_pairs(), m.size_frame, m.size_img, m.size_txt)

    def traced_work(self):
        for _ in range(self.traffic["trace_evals"]):
            self.one_eval()

    def trace_work_count(self) -> dict:
        return {"evals": self.traffic["trace_evals"]}

    def gap_work(self):
        self.one_eval()

    def fusion_attention_calls(self, evals: int):
        m = self.run_cfg.model
        length = work.video_tokens(self.dims, m.size_frame, m.size_img) + m.size_txt
        return evals * work.self_attention_calls(self.dims["fusion"], self.n_pairs(), length,
                                                 False)

    def keep_outputs(self):
        """The last eval's video bank rows (by item) and its score matrix
        (captions x videos), for the check."""
        n = self.traffic["captions"]
        bank = torch.cat(self.recorder.enc)[:n]
        scores = torch.cat(self.recorder.scores)[:n * n].float().view(n, n)
        self.checks["bank"] = bank
        self.checks["scores"] = scores

    def teacher_ms(self):
        return None


ENTRIES = {"pretrain_step": PretrainEntry, "retrieval_eval": RetrievalEvalEntry}
