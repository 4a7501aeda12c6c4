"""Torch's CPU threads for the port's tests under pytest-xdist.

Each xdist worker shares the host's cores with the others. Torch's OpenMP
pool is sized to every core by default, and its idle threads spin after
each parallel region, so six workers of eight threads each on eight cores
keep the cores busy spinning: six concurrent copies of the encoder cases
of ``test_torch_encoders2d.py`` on an eight-core host take 233 s at eight
threads each and 70 s at one. A module that imports :func:`torch_threads`
runs at its worker's share of the cores; a run without xdist keeps
torch's default.

``test_torch_pretrain.py`` and ``test_torch_grad_accum.py`` do not import
it: their two-step checks allow no parameter beyond 2e-6 among the
resolved ones, and at one or two threads torch's summation order moves
one element of the swin's MLP to 3.5e-6 (at four and eight they pass).
"""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    if workers > 1:
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))
    yield
    torch.set_num_threads(before)
