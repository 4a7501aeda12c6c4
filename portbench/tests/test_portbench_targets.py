"""MVM targets as files found by name (``reference/targets/``): the two the
benchmark runs give the figures they gave before they were files, a new
target comes in as new files alone, a checked number reaches the program's
module through its hook, and a target without a teacher times none."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from portbench.harness import check, spec, work
from portbench.harness.entries import ENTRIES
from portbench.reference import targets
from portbench.tests.test_portbench_reference import SEED, program_readings
from portbench.tests.tiny import TINY_BERT, TINY_SWIN, tiny_cell

CPU = torch.device("cpu")

# taken with the targets still written into the reference and the FLOP count
STEP_FLOPS = {"2d_feature": 20434015436800.0, "pixel": 17955979345920.0}
TINY_LOSSES = {
    "2d_feature": [
        {"mtm": 7.031099796295166, "vtm": 1.4418236017227173,
         "mvm_2d_feature": 332.5333251953125, "total": 341.0062561035156},
        {"mtm": 6.979302883148193, "vtm": 1.4336479902267456,
         "mvm_2d_feature": 328.1257629394531, "total": 336.5387268066406},
        {"mtm": 0.0, "vtm": 1.3307280540466309, "mvm_2d_feature": 332.0079650878906,
         "total": 333.33868408203125}],
    "pixel": [
        {"mtm": 7.128610134124756, "vtm": 1.3156788349151611, "mvm_pixel": 1.1349881887435913,
         "total": 9.579277038574219},
        {"mtm": 6.921253204345703, "vtm": 1.3612322807312012, "mvm_pixel": 1.124494194984436,
         "total": 9.406980514526367},
        {"mtm": 0.0, "vtm": 1.5164718627929688, "mvm_pixel": 1.12396240234375,
         "total": 2.6404342651367188}]}


@pytest.mark.parametrize("target", sorted(STEP_FLOPS))
def test_step_flops_unchanged(target):
    config = json.loads((spec.ROOT / "portbench/configs/violet-base-pretrain.json").read_text())
    run = dict(config["run"], mvm_target=[target])
    assert work.pretrain_step_flops(config["dims"], run, 20) == STEP_FLOPS[target]


@pytest.mark.parametrize("target", sorted(TINY_LOSSES))
def test_tiny_reference_losses_unchanged(target):
    cell = tiny_cell("pretrain-2dfeat", mvm_target=target)
    losses = check.reference_train(cell, SEED, CPU)["losses"]
    assert [list(step) for step in losses] == [list(step) for step in TINY_LOSSES[target]]
    for got, want in zip(losses, TINY_LOSSES[target]):
        assert got == pytest.approx(want, rel=1e-6, abs=1e-6)


def test_a_target_without_a_file_is_refused():
    with pytest.raises(ValueError, match=r"no target file .*targets/flow_of_nothing\.py"):
        targets.load("flow_of_nothing")


def test_pixel_times_no_teacher():
    """A target without a teacher call: ``teacher_ms`` gives None (the traced
    run reports no ``teacher.fwd_ms``) before it touches the card."""
    cell = tiny_cell("pretrain-2dfeat", mvm_target="pixel")
    entry = ENTRIES[cell.traffic["entry"]](cell, SEED, CPU)
    entry.setup()
    assert entry.teacher_ms() is None
    assert targets.load("2d_feature").teacher_call is not None
    entry.release()


def test_checked_number_reads_the_programs_module(monkeypatch):
    """A target's checked number: the hook keeps the program module's
    first-step output, the reference puts its own in ``mvm.kept``, and the
    check compares the two as it does the VTM scores."""
    pixel = targets.load("pixel")
    losses = pixel.losses

    def kept_losses(model, mvm):
        out = model.decoder_pixel(mvm.grid).detach().reshape(-1)
        mvm.kept["decoder_gap"] = (out, out)
        return losses(model, mvm)

    monkeypatch.setattr(pixel, "CHECKED", {"decoder_gap": "decoder_pixel"}, raising=False)
    monkeypatch.setattr(pixel, "losses", kept_losses)
    cell = tiny_cell("pretrain-2dfeat", mvm_target="pixel")
    prog = program_readings(cell)
    assert set(prog["kept"]) == {"decoder_gap"}
    numbers = check.reference_numbers(cell, SEED, CPU, prog)
    assert numbers["decoder_gap"] < 1e-4
    prog["kept"]["decoder_gap"] = prog["kept"]["decoder_gap"] + 1.0
    assert check.reference_numbers(cell, SEED, CPU, prog)["decoder_gap"] > 0.1


TOY_TARGET = '''
"""A toy MVM target: a frozen linear teacher of each patch's pixels,
regressed from the fused patch tokens by a linear head."""

import torch

from portbench.reference.model import Linear
from portbench.reference.steps import masked_l1
from portbench.reference.targets import Rule

LOSS_ORDER = 70
FROZEN = ("toy_teacher.",)
WEIGHT_RULES = [Rule(r"^toy_teacher\\.weight$", "fan_in", 1.0),
                Rule(r"^toy_teacher\\.bias$", "value", 0.5)]
CHECKED = {"toy_gap": "toy_teacher"}


def build(model, dims, num):
    ps, k = dims["size_patch"], dims["toy"]["width"]
    model.toy_head = Linear(dims["fusion"]["hidden_size"], k, num=num)
    model.toy_teacher = Linear(ps * ps * 3, k, num=num)
    model.toy_teacher.requires_grad_(False)


def patches(img, ps):
    b, t, hh, ww, c = img.shape
    x = img.reshape(b, t, hh // ps, ps, ww // ps, ps, c).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(b, t, hh // ps, ww // ps, ps * ps * c)


def losses(model, mvm):
    with torch.no_grad():
        target = model.toy_teacher(patches(mvm.img, model.cfg["size_patch"]))
    mvm.kept["toy_gap"] = (target.reshape(-1), target.reshape(-1))
    return {"mvm_toy": masked_l1(model.toy_head(mvm.grid), target, mvm.cov[..., None])}


def flops(dims, run, batch, count):
    ps, k, d = dims["size_patch"], dims["toy"]["width"], dims["fusion"]["hidden_size"]
    rows = batch * run["size_frame"] * (run["size_img"] // ps) ** 2
    return 2.0 * rows * d * k, 2.0 * rows * ps * ps * 3 * k


def teacher_call(model, img):
    return model.toy_teacher(patches(img, model.config.size_patch))
'''

TOY_RUN = '''
import json, math, sys
import torch
from portbench import control
from portbench.harness import check, inputs, spec, work

cpu = torch.device("cpu")
seed = 2 ** 34 + 3
cell = spec.load_cell("pretrain-toy")
dims, run = cell.config["dims"], cell.config["run"]
rows = 20 * 2 * 2 * 2
none = work.pretrain_step_flops(dims, dict(run, pretrain_tasks=["vtm", "mtm"]), 20)
model = check._ref_model(cell, "fp32", cpu)
specs = inputs.param_specs(model)
ruled = inputs.make_weights(specs, seed, cpu, model.weight_rules)
plain = inputs.make_weights(specs, seed, cpu)
ref = check.reference_train(cell, seed, cpu)
sound = check.train_numbers(ref, ref)
off = check.train_numbers(dict(ref, kept={"toy_gap": ref["kept"]["toy_gap"] + 1.0}), ref)
faults = control.fault_readings(cell, seed, cpu)
try:
    spec.load_cell("pretrain-toy-unjudged")
    unjudged = None
except ValueError as e:
    unjudged = str(e)
print(json.dumps({
    "root": str(spec.ROOT),
    "limits": cell.limits,
    "extra_flops": work.pretrain_step_flops(dims, run, 20) - none,
    "by_hand": 3 * 2.0 * rows * 64 * 24 + 2.0 * rows * 32 * 32 * 3 * 24,
    "bias": sorted(set(ruled["toy_teacher.bias"].tolist())),
    "weight_ratio": float((ruled["toy_teacher.weight"] / plain["toy_teacher.weight"]).mean()),
    "others_equal": all(torch.equal(ruled[n], plain[n]) for n in specs
                        if not n.startswith("toy_teacher.")),
    "loss_names": [sorted(step) for step in ref["losses"]],
    "totals_add_up": all(math.isclose(s["total"], sum(v for k, v in s.items() if k != "total"),
                                      rel_tol=1e-6) for s in ref["losses"]),
    "moved": sorted(ref["delta"]),
    "sound": {k: v for k, v in sound.items() if k != "worst_leaves"},
    "verdict_sound": check.verdict(sound, cell.limits, 0)[0],
    "off_toy_gap": off["toy_gap"],
    "verdict_off": check.verdict(off, cell.limits, 0)[0],
    "faults": {kind: numbers["toy_gap"] for kind, numbers in faults.items()},
    "verdict_faults": [check.verdict(n, cell.limits, 0)[0] for n in faults.values()],
    "unjudged": unjudged,
}))
'''


def _hashes(root):
    """sha256 of ``BENCHMARK.json`` and every file under ``portbench/``."""
    files = [root / "BENCHMARK.json", *(root / "portbench").rglob("*")]
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in files if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_target_comes_as_files_alone(tmp_path):
    """A root made of copies of ``BENCHMARK.json`` and ``portbench/`` takes a
    toy target with a teacher, a weight rule and a checked number as new
    files and entries: the cell loads, the FLOP count, the weight draw, the
    reference step, the check and the control take it, a cell without a
    limit for its checked number is refused, and no file that was there
    changes."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _hashes(tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    base = spec.load_cell("pretrain-2dfeat")

    config = json.loads(json.dumps(base.config))
    config["name"] = "toy-pretrain"
    config["run"].update(size_img=64, size_frame=2, size_txt=8, mvm_target=["toy"],
                         swin_custom={k: TINY_SWIN[k] for k in TINY_SWIN if k != "final_norm"},
                         fusion=dict(TINY_BERT), text=dict(TINY_BERT))
    config["dims"].update(swin=dict(TINY_SWIN), fusion=dict(TINY_BERT), text=dict(TINY_BERT),
                          toy={"width": 24})
    del config["dims"]["teacher"]
    pb = tmp_path / "portbench"
    (pb / "reference/targets/toy.py").write_text(textwrap.dedent(TOY_TARGET))
    (pb / "configs/toy-pretrain.json").write_text(json.dumps(config, indent=1))
    (pb / "cells/pretrain-toy.json").write_text(json.dumps(
        {"limits": dict(base.limits, toy_gap=0.1), "readings": {}}, indent=1))
    (pb / "cells/pretrain-toy-unjudged.json").write_text(json.dumps(
        {"limits": dict(base.limits), "readings": {}}, indent=1))
    bench["configs"].append({"name": "toy-pretrain", "source": "https://arxiv.org/abs/2209.01540",
                             "file": "portbench/configs/toy-pretrain.json", "reduced": [],
                             "why": "a toy target"})
    bench["workloads"].append({"name": "pretrain-toy", "config": "toy-pretrain",
                               "traffic": "pretrain-b20", "chips": 1, "why": "a toy target"})
    bench["workloads"].append({"name": "pretrain-toy-unjudged", "config": "toy-pretrain",
                               "traffic": "pretrain-b20", "chips": 1,
                               "why": "a toy target whose checked number has no limit"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))

    out = subprocess.run([sys.executable, "-c", TOY_RUN], capture_output=True, text=True,
                         cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(tmp_path)),
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["root"] == str(tmp_path)
    assert got["limits"]["toy_gap"] == 0.1
    assert got["extra_flops"] == pytest.approx(got["by_hand"], rel=1e-9)
    assert got["bias"] == [0.5]
    assert got["weight_ratio"] == pytest.approx(1.0 / (32 * 32 * 3) ** 0.5 / 0.02, rel=1e-5)
    assert got["others_equal"]
    assert got["loss_names"] == [["mtm", "mvm_toy", "total", "vtm"]] * 3
    assert got["totals_add_up"]
    assert "toy_head.weight" in got["moved"]
    assert not any(n.startswith("toy_teacher.") for n in got["moved"])
    assert got["sound"]["toy_gap"] == 0.0 and got["verdict_sound"]
    assert got["off_toy_gap"] > 0.1 and not got["verdict_off"]
    # the control and the half batch stand in the program's place and read the number
    assert set(got["faults"]) == {"control", "half_batch"}
    assert 0.0 < got["faults"]["control"] < float("inf")
    assert not any(got["verdict_faults"])
    assert "pretrain-toy-unjudged" in got["unjudged"] and "['toy_gap']" in got["unjudged"]

    after = _hashes(tmp_path)
    old = {name: digest for name, digest in after.items() if name in before}
    assert set(old) == set(before)
    changed = {name for name in before if old[name] != before[name]}
    assert changed == {"BENCHMARK.json"}
    assert before == {k: v for k, v in _hashes(spec.ROOT).items() if k in before}
    original = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    now = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for key, entries in original.items():
        assert now[key][:len(entries)] == entries if isinstance(entries, list) \
            else now[key] == entries
