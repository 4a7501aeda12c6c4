"""Retrieval parity against the reference's published numbers in one
command (counterpart of ``empirical_mvm_tpu/cli/parity_eval.py``;
BASELINE.md table 3; ref: eval_retrieval_tsv.py:32-92, model.py:295-386):

  python -m empirical_mvm_torch.cli.parity_eval \
      --config configs/msrvtt-retrieval.json \
      --path_ckpt ckpt_violet_msrvtt-retrieval.pt \
      [--tol 0.5] [--expected 36.3,64.9,75.5]

A reference ``.pt`` (trainer-wrapped or raw) or a ``.msgpack`` of either
package -> the lenient load -> the two-stage retrieval eval -> R@1/5/10 and
MedR, each held to the expected number within ``--tol`` points. Prints one
JSON line with the metrics and a verdict per metric, and exits with 1 when
any metric misses. The expected numbers default to BASELINE.md's "Repo"
column for the config's dataset (msrvtt, didemo, lsmdc).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from empirical_mvm_torch.cli import common
from empirical_mvm_torch.cli.retrieval import build_model
from empirical_mvm_torch.cli.retrieval_eval import DecodedClips, eval_split
from empirical_mvm_torch.core.config import load_run_config
from empirical_mvm_torch.parallel.mesh import default_data_parallel
from empirical_mvm_torch.train.evaluators import retrieval_two_stage_eval

# BASELINE.md table 3, "Repo reproduction" column (R@1/R@5/R@10)
BASELINE_T2V = {
    "msrvtt": (36.3, 64.9, 75.5),
    "didemo": (46.0, 74.1, 83.9),
    "lsmdc": (25.1, 44.2, 54.9),
}


def main(argv=None, *, device="cuda", decode=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Reference-checkpoint retrieval parity in one command")
    ap.add_argument("--config", required=True, help="task JSON config")
    ap.add_argument("--path_ckpt", required=True,
                    help="reference .pt (wrapped ok) or native .msgpack")
    ap.add_argument("--tol", type=float, default=0.5,
                    help="max |ours - expected| per metric, pts")
    ap.add_argument("--expected", default=None,
                    help="R@1,R@5,R@10 override; default from BASELINE.md by dataset name")
    args, _rest = ap.parse_known_args(argv)
    device = common.run_device(device, decode)

    cfg = load_run_config(args.config)
    cfg = common.adopt_ckpt_args(dataclasses.replace(cfg, path_ckpt=args.path_ckpt))
    cfg = common.setup_run(cfg, device)
    split, ds = eval_split(cfg, common.get_tokenizer(cfg))
    model = build_model(cfg, device)
    common.load_initial_params(cfg, model)
    metrics = retrieval_two_stage_eval(model, DecodedClips(ds, device, decode), device=device,
                                       dp=default_data_parallel())

    if args.expected:
        expected = tuple(float(v) for v in args.expected.split(","))
    else:
        ds_name = cfg.data.dataset[0] if cfg.data.dataset else cfg.task.split("-")[0]
        expected = BASELINE_T2V.get(ds_name)
    verdict = {}
    ok = True
    if expected is not None:
        for key, want in zip(("r1", "r5", "r10"), expected):
            got = float(metrics[key])
            hit = abs(got - want) <= args.tol
            verdict[key] = {"got": round(got, 2), "want": want, "ok": hit}
            ok = ok and hit
    out = {"task": cfg.task, "split": split, **{k: float(v) for k, v in metrics.items()},
           "expected": expected, "tol": args.tol, "verdict": verdict, "parity_ok": bool(ok)}
    print(json.dumps(out), flush=True)
    if expected is not None and not ok:
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
