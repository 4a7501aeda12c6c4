"""With the timed path broken underneath, a run comes out not correct:
a tiny dry run on the CPU (past the command's look for a card) with one
fault planted in the program for each fault the cell can have. The cells
run on one card, so no exchange between cards can be left out."""

import time

import pytest
import torch

from empirical_mvm_torch.models.tasks import VioletRetrieval
from empirical_mvm_torch.train import train_step
from portbench.harness import measure
from portbench.tests.tiny import tiny_cell

CPU = torch.device("cpu")
SEED = 2 ** 35 + 99
STEPS = {"pretrain-2dfeat": "make_pretrain_train_step"}


def run(name):
    return measure.measure(tiny_cell(name), SEED, 0.2, False, CPU, time.time())


@pytest.mark.parametrize("name", list(STEPS))
def test_sound_run_is_correct(name):
    assert run(name)["correct"] is True


@pytest.mark.parametrize("name", list(STEPS))
def test_state_unchanged(name, monkeypatch):
    """A step that returns its state unchanged: no update, no moments."""
    real = getattr(train_step, STEPS[name])

    def make(model, opt, *args, **kwargs):
        step = real(model, opt, *args, **kwargs)

        def frozen_step(state, batch, seed):
            with torch.no_grad():
                before = {n: p.detach().clone() for n, p in state.params.items()}
                mu = {n: m.clone() for n, m in state.opt_state["mu"].items()}
                nu = {n: m.clone() for n, m in state.opt_state["nu"].items()}
            new, losses = step(state, batch, seed)
            with torch.no_grad():
                for n, p in new.params.items():
                    p.copy_(before[n])
                new.opt_state["mu"].update(mu)
                new.opt_state["nu"].update(nu)
            return state, losses

        return frozen_step

    monkeypatch.setattr(train_step, STEPS[name], make)
    result = run(name)
    assert result["correct"] is False
    assert result["checked"]["delta_gap"]["value"] > result["checked"]["delta_gap"]["limit"]


@pytest.mark.parametrize("name", list(STEPS))
def test_half_batch(name, monkeypatch):
    """Half of each batch left out, the losses' means taken over the rest."""
    real = getattr(train_step, STEPS[name])

    def make(model, opt, *args, **kwargs):
        step = real(model, opt, *args, **kwargs)

        def half_step(state, batch, seed):
            half = {k: v[: len(v) // 2] for k, v in batch.items()}
            return step(state, half, seed)

        return half_step

    monkeypatch.setattr(train_step, STEPS[name], make)
    assert run(name)["correct"] is False


def test_eval_answer_altered(monkeypatch):
    """One score of each stage-2 call altered where it is produced."""
    real = VioletRetrieval.score_pairs

    def altered(self, *args):
        out = real(self, *args).clone()
        out[1] += 0.5
        return out

    monkeypatch.setattr(VioletRetrieval, "score_pairs", altered)
    result = run("msrvtt-ret-eval")
    assert result["correct"] is False
    assert result["checked"]["score_gap"]["value"] > result["checked"]["score_gap"]["limit"]


def test_eval_half_batch(monkeypatch):
    """Half of each stage-1 batch left out: its rows of the banks stay zero."""
    real = VioletRetrieval.encode

    def half(self, img, txt, mask):
        fi, mi, ft, mt = real(self, img, txt, mask)
        k = len(fi) // 2
        fi = fi.clone()
        fi[k:] = 0
        return fi, mi, ft, mt

    monkeypatch.setattr(VioletRetrieval, "encode", half)
    assert run("msrvtt-ret-eval")["correct"] is False


def test_eval_sound_run_is_correct():
    assert run("msrvtt-ret-eval")["correct"] is True
