"""The control and the planted faults of ``portbench/control.py``. On the
card (``cuda``) at each cell's own size, each comes out not correct
against the cell's limits. On the CPU at a tiny width, where the program
runs its plain float32 path and reads next to nothing, each reads far above
the sound program on some compared number (the limits are set at the
cells' size and do not carry over to a tiny width)."""

import pytest
import torch

from portbench import control
from portbench.harness import check, spec
from portbench.tests.test_portbench_reference import program_readings
from portbench.tests.tiny import tiny_cell

NAMES = ["pretrain-2dfeat", "msrvtt-ret-eval"]
SEED = 2 ** 33 + 5


@pytest.mark.parametrize("name", NAMES)
def test_control_and_faults_stand_out_tiny(name):
    cell = tiny_cell(name)
    cpu = torch.device("cpu")
    sound = check.reference_numbers(cell, SEED, cpu, program_readings(cell, SEED))
    readings = control.fault_readings(cell, SEED, cpu)
    assert set(readings) >= {"control", "half_batch"}
    for numbers in readings.values():
        assert any(numbers[k] > 100 * max(sound[k], 1e-6) for k in cell.limits), numbers


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_control_and_faults_fail_on_card(name, card):
    cell = spec.load_cell(name)
    readings = control.fault_readings(cell, 2 ** 33 + 6, card)
    assert all(not check.verdict(numbers, cell.limits, 0)[0] for numbers in readings.values())
