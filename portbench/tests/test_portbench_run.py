"""A dry run of each cell at a tiny width on the CPU gives a result of the
contract's shape; the command refuses to measure without a card."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench.harness import measure, spec
from portbench.tests.tiny import tiny_cell

WORKLOADS = [w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", WORKLOADS)
def test_dry_run_line(name, trace):
    cell = tiny_cell(name)
    result = measure.measure(cell, 2 ** 40 + 7, 0.3, bool(trace), torch.device("cpu"),
                             time.time())
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checked"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert line["device"]["platform"] == "cpu"
    assert set(line["checked"]) == set(cell.limits)
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert "setup_s" in line["metrics"]
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]


def _run(cwd, env_extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **env_extra)
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "pretrain-2dfeat",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=cwd, env=env, timeout=120)


def test_no_card_no_result():
    out = _run(spec.ROOT, {})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, {})
    assert out.returncode != 0 and out.stdout.strip() == ""
