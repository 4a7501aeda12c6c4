"""The MVM targets the benchmark defines, one file each, found by the name a
run configuration's ``mvm_target`` gives: ``targets/<mvm_target>.py``. A
target with no file is refused, naming the path looked for.

A target file imports only torch and ``portbench.reference`` (never the
program) and defines:

* ``LOSS_ORDER``: the place of its loss in the program's sum
  (``models/pretrain.py`` ``VioletPretrain.losses``); the reference builds
  the targets, adds their losses and draws their dropouts in this order;
* ``FROZEN``: the name prefixes of its frozen teacher's parameters, which
  no step moves (empty without a teacher);
* ``build(model, dims, num)``: the reference's head and teacher, from the
  configuration's ``dims`` and the ``Numerics`` given (the control's fp8
  reaches them), registered on ``model`` under the program's state-dict
  names;
* ``losses(model, mvm)``: its losses by name, from the reference step's
  :class:`portbench.reference.steps.MVMInputs`;
* ``flops(dims, run, batch, count)``: one step's (trained, teacher) FLOPs
  at ``batch`` clips, the trained part's forward alone (the FLOP count
  triples it) and the teacher's forward; ``count`` is
  ``portbench/harness/work.py``, its counters handed in;
* ``teacher_call``: ``f(program_model, normalized_clip)``, the program's
  no-grad teacher call that ``teacher.fwd_ms`` times, or None.

and may define:

* ``WEIGHT_RULES``: :class:`Rule` s that replace N(0, 0.02) for the
  parameters whose name they match;
* ``CHECKED``: compared number -> the program module (a path from the
  model) whose first-step output a hook keeps; ``losses`` puts the
  reference's output and its scale in ``mvm.kept[number]`` as a pair, and
  the number is computed as the VTM scores' (``check.scaled_score_gap``).
  Its limit lives in the cell's ``cells/<workload>.json``; a cell without
  it is refused when it loads.
"""

from __future__ import annotations

import importlib
import re
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_-]{0,63}")     # a module's name: no dot


class Rule(NamedTuple):
    """Parameters whose name ``pattern`` matches (``re.search``) are set to
    ``number`` (``kind`` "value"), drawn with std ``number`` ("std"), or
    with std ``number`` / sqrt(fan-in) ("fan_in": a weight's elements per
    output row)."""
    pattern: str
    kind: str
    number: float


def path(name: str) -> Path:
    return HERE / f"{name}.py"


def load(name: str):
    """The module of target ``name``, imported once."""
    key = f"{__name__}.{name}"
    try:
        if _NAME.fullmatch(name):
            return importlib.import_module(key)
    except ModuleNotFoundError as e:
        if e.name != key:
            raise
    raise ValueError(f"mvm_target {name!r}: no target file {path(name)}; neither the "
                     "reference nor the FLOP count defines it")


def ordered(names) -> list:
    """The modules of ``names``, in the order of their losses."""
    return sorted((load(n) for n in names), key=lambda t: t.LOSS_ORDER)


def weight_rules(modules) -> list[Rule]:
    return [rule for t in modules for rule in getattr(t, "WEIGHT_RULES", ())]


def checked(modules) -> dict[str, str]:
    return {name: where for t in modules for name, where in getattr(t, "CHECKED", {}).items()}
