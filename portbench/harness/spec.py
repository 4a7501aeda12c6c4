"""Finding a cell's parts by name: its entry in ``BENCHMARK.json``, its
configuration file (``configs/<config>.json``, the path the entry names),
its traffic mix (``traffic/<traffic>.json``), its limits
(``cells/<workload>.json``) and the reader of each metric it reports
(``metrics/<metric>.py``, a ``read(ctx)`` returning a number or None).
A pretrain configuration that the reference does not define, or whose
step the FLOP count does not cover, is refused here, before any run."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent          # portbench/
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = by_name[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "portbench" / "cells" / f"{name}.json").read_text())["limits"]
    if traffic["entry"] == "pretrain_step":
        from portbench.harness.work import pretrain_step_flops
        from portbench.reference.steps import check_supported
        check_supported(config["run"])
        pretrain_step_flops(config["dims"], config["run"], traffic["batch"])
    return Cell(name=name, workload=w, config=config, traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``portbench/metrics/<metric>.py``."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
