"""The correctness check's control and planted faults, at a cell's own size.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...]

For each seed it prints, as one JSON line, the numbers the check compares
(``harness/check.py``) for readings that must come out not correct, each
against the fp32 reference:

* ``control``: the reference itself computed with float8 e4m3 operands in
  every matrix product (the precision below the configuration's bf16);
* train cells, ``half_batch``: the reference on half of each batch's rows,
  the losses' means taken over the rest;
* the eval cell, ``half_batch``: half of each stage-1 batch encoded, the
  other half's bank rows left at zero; ``answer``: one score of each
  stage-2 call altered by one.

A step that returns its state unchanged reads 1 in ``grad_gap`` and
``delta_gap`` by their definition and needs no run. The benchmark's own
runs never run this; ``tests/test_portbench_control.py`` runs it at a
tiny width.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def fault_readings(cell, seed: int, device) -> dict:
    from portbench.harness import check
    out = {}
    with check.exact_fp32():
        if cell.traffic["entry"] == "retrieval_eval":
            ref = check.reference_eval(cell, seed, device)
            ctrl = check.reference_eval(cell, seed, device, "fp8")
            out["control"] = check.eval_numbers(ctrl, ref)
            half = {"bank": ref["bank"].clone(), "scores": ref["scores"]}
            b = cell.traffic["encode_batch"]
            for r0 in range(0, len(half["bank"]), b):
                half["bank"][r0 + b // 2:r0 + b] = 0
            out["half_batch"] = check.eval_numbers(half, ref)
            altered = ref["scores"].clone().view(-1)
            altered[::cell.traffic["chunk_size"]] += 1.0
            out["answer"] = check.eval_numbers({"bank": ref["bank"],
                                                "scores": altered.view_as(ref["scores"])}, ref)
        else:
            ref = check.reference_train(cell, seed, device)
            ctrl = check.reference_train(cell, seed, device, "fp8")
            out["control"] = check.train_numbers(ctrl, ref)
            half = check.reference_train(cell, seed, device,
                                         batch_rows=cell.traffic["batch"] // 2)
            out["half_batch"] = check.train_numbers(half, ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.harness import spec
    if not torch.cuda.is_available():
        print("control.py measures at the cell's size on a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, ROOT)
    for seed in args.seeds:
        readings = fault_readings(cell, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed, **readings}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
