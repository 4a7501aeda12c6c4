"""The plain reference agrees with empirical_mvm_torch at a tiny width on
the CPU, where the program runs its plain paths in float32: the same
masks, negatives and dropouts, the same losses, gradients and updates."""

import pytest
import torch

from portbench.harness import check, inputs
from portbench.harness.entries import ENTRIES
from portbench.tests.tiny import tiny_cell

SEED = 2 ** 33 + 12345          # wider than 32 bits, as the command's --seed may be
CPU = torch.device("cpu")


def program_readings(cell, seed=SEED):
    entry = ENTRIES[cell.traffic["entry"]](cell, seed, CPU)
    entry.setup()
    if cell.traffic["entry"] == "retrieval_eval":
        entry.one_eval()
        entry.keep_outputs()
    readings = dict(entry.checks)
    entry.release()
    return readings


@pytest.mark.parametrize("target", ["2d_feature", "pixel"])
def test_train_steps_agree(target):
    cell = tiny_cell("pretrain-2dfeat", mvm_target=target)
    numbers = check.reference_numbers(cell, SEED, CPU, program_readings(cell))
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-4
    assert numbers["delta_gap"] < 5e-3
    assert numbers["vtm_score_gap"] < 1e-4


def test_eval_agrees():
    cell = tiny_cell("msrvtt-ret-eval")
    numbers = check.reference_numbers(cell, SEED, CPU, program_readings(cell))
    assert numbers["score_gap"] < 1e-5 and numbers["bank_gap"] < 1e-5


@pytest.mark.parametrize("name,target", [("pretrain-2dfeat", None), ("pretrain-2dfeat", "pixel"),
                                         ("msrvtt-ret-eval", None)])
def test_same_parameters_and_weights(name, target):
    """The reference holds the program's parameter names and shapes, and the
    seeded weights put LayerNorm weights at 1 by name exactly where the
    program has LayerNorms."""
    from empirical_mvm_torch.models.pretrain import VioletPretrain
    from empirical_mvm_torch.models.tasks import VioletRetrieval
    from empirical_mvm_torch.ops.layernorm import LayerNorm
    cell = tiny_cell(name, mvm_target=target)
    run = ENTRIES[cell.traffic["entry"]](cell, SEED, CPU).run_cfg
    model = (VioletPretrain.from_run_config(run, device="cpu") if name == "pretrain-2dfeat"
             else VioletRetrieval(run.model, device="cpu"))
    ref = check._ref_model(cell, "fp32", CPU)
    assert inputs.param_specs(model) == inputs.param_specs(ref)
    norms = {f"{n}.weight" for n, m in model.named_modules() if isinstance(m, LayerNorm)}
    assert {n for n in inputs.param_specs(model) if inputs.weight_kind(n) == "one"} == norms
    a = inputs.make_weights(inputs.param_specs(model), SEED, CPU)
    b = inputs.make_weights(dict(reversed(list(inputs.param_specs(ref).items()))), SEED, CPU)
    assert all(torch.equal(a[n], b[n]) for n in a)


@pytest.mark.parametrize("key,value", [("mvm_target", ["vq"]), ("pretrain_tasks", ["mvm", "smtm"]),
                                       ("pretrain_masks", ["am", "rm"])])
def test_undefined_pretrain_runs_are_refused(key, value):
    """A configuration the reference does not define is refused before any
    run, by the reference and by the FLOP count alike."""
    from portbench.harness import work
    from portbench.reference.steps import check_supported
    cell = tiny_cell("pretrain-2dfeat")
    run = dict(cell.config["run"], **{key: value})
    with pytest.raises(ValueError, match=key):
        check_supported(run)
    if key != "pretrain_masks":
        with pytest.raises(ValueError, match="FLOP count"):
            work.pretrain_step_flops(cell.config["dims"], run, 4)
