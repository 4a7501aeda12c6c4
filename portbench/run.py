"""The benchmark of empirical_mvm_torch on the card: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell's parts are found by name (see
``portbench/README.md``). The last line of standard output is the result,
one JSON object; the last lines of standard error give each number the
correctness check compared, beside its limit. Exits 2, printing no result,
without as many CUDA cards as the cell asks for; 3 if a JAX module was
loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "empirical_mvm_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a JAX package's, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench.harness import measure, spec

    cell = spec.load_cell(args.workload, ROOT)
    need = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"{args.workload} needs {need} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = measure.measure(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"JAX modules were loaded: {bad}", file=sys.stderr)
        return 3
    measure.report_limits(result["checked"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
