"""How ``correct`` is decided: the program's outputs against the plain
reference (``portbench/reference``), run after the window on the same
seeded weights and inputs, the reference rebuilding everything else itself.

Train cells compare the first ``check_steps`` steps the program ran in its
set-up, through the window's own step and feed:

* ``loss_gap``: the largest |program - reference| / |reference| of any
  loss (each term and the total) of any of those steps;
* ``grad_gap``: the worst leaf's gap between the norms of the first
  step's clipped gradient (the program's worked out from AdamW's first
  moment after one step, mu / (1 - beta1)), over the larger of the
  reference's norm of that leaf and of the median leaf;
* ``delta_gap``: the same for the norm of each leaf's change over the
  steps;
* ``vtm_score_gap``: the first step's VTM scores (positive rows, then
  negative rows) against the reference's, as the eval's ``score_gap``;
* each checked number of the run's MVM targets (``reference/targets/``):
  the first-step output of the program module the target names, against
  the reference's with its scale, as ``vtm_score_gap``.

Leaves whose reference gradient is under a thousandth of the median
leaf's (a rule on the reference's gradient, not on names) move under Adam
by round-off alone and are left out of both leaf numbers.

The eval cell compares every answer of the last eval of the window:
``score_gap``, the largest |program - reference| over all caption x video
scores, over the root mean square of the scores' scales (the norm of the
terms w_i relu(h)_i that the score head's last product sums: a score near
0 by cancellation still has the scale its rounding works on); and
``bank_gap``, the worst video's relative distance ||program - reference||
/ ||reference|| between the stage-1 video tokens.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.harness import inputs

LEAF_FLOOR = 1e-3


def _ref_model(cell, numerics: str, device):
    from portbench.reference.model import Numerics, VioletPretrain, VioletRetrieval
    with torch.device(device):
        if cell.traffic["entry"] == "pretrain_step":
            return VioletPretrain(cell.config["dims"], Numerics(numerics),
                                  cell.config["run"]["mvm_target"])
        return VioletRetrieval(cell.config["dims"], Numerics(numerics))


def reference_train(cell, seed: int, device, numerics: str = "fp32", batch_rows=None):
    """The reference's readings of the first ``check_steps`` steps: losses,
    first-gradient norms and change norms by leaf, the first step's VTM
    scores and each checked output, in the program's shape (``kept``), with
    their scales apart (``scales``, ``kept_scales``), so that the readings
    can stand in the program's place. ``batch_rows`` keeps only that many
    rows of each batch (a planted fault)."""
    from portbench.reference.steps import train_steps
    t, run = cell.traffic, cell.config["run"]
    dims = cell.config["dims"]
    model = _ref_model(cell, numerics, device)
    specs = inputs.param_specs(model)
    weights = inputs.make_weights(specs, seed, device, model.weight_rules)
    inputs.load_weights(model, weights)
    pool = inputs.train_pool(seed, t["pool"], t["batch"], run["size_frame"], run["size_img"],
                             run["size_txt"], dims["text"]["vocab_size"], device)
    batches = pool[:t["check_steps"]]
    if batch_rows is not None:
        batches = [{k: v[:batch_rows] for k, v in b.items()} for b in batches]
    losses, first_grad, params, (scores, scales), kept = train_steps(
        model, batches, seed, run, cell.config["assumed"]["max_iter"])
    names = sorted(params)
    deltas = torch.stack(torch._foreach_norm([params[n].detach() - weights[n] for n in names]))
    return {"losses": losses, "first_grad": first_grad, "delta": dict(zip(names, deltas.tolist())),
            "scores": scores, "scales": scales,
            "kept": {name: out for name, (out, _) in kept.items()},
            "kept_scales": {name: scale for name, (_, scale) in kept.items()}}


def scaled_score_gap(prog_scores, ref_scores, ref_scales) -> float:
    """max |program - reference| over the scores, over the root mean square
    of the reference's scales (the norm of the terms the score head's last
    product sums: a score near 0 by cancellation still has the scale its
    rounding works on)."""
    ps, rs = prog_scores.float().reshape(-1), ref_scores.float().reshape(-1)
    if ps.shape != rs.shape:
        return math.inf
    gap = float((ps - rs).abs().max() / ref_scales.float().square().mean().sqrt().clamp(min=1e-30))
    return gap if math.isfinite(gap) else math.inf


def train_numbers(prog: dict, ref: dict) -> dict:
    if len(prog["losses"]) != len(ref["losses"]):
        return dict.fromkeys(("loss_gap", "grad_gap", "delta_gap", "vtm_score_gap",
                              *ref["kept"]), math.inf)

    loss_gap = 0.0
    for p_step, r_step in zip(prog["losses"], ref["losses"]):
        for k, r in r_step.items():
            p = p_step.get(k, math.nan)
            loss_gap = max(loss_gap, abs(p - r) / max(abs(r), 1e-12) if math.isfinite(p)
                           else math.inf)
    rg = ref["first_grad"]
    med = float(np.median(list(rg.values())))
    leaves = [n for n, g in rg.items() if g >= LEAF_FLOOR * med]
    med_d = float(np.median([ref["delta"][n] for n in rg]))

    def gaps(pv, rv, floor):
        out = {}
        for n in leaves:
            p = pv.get(n, math.nan)
            out[n] = abs(p - rv[n]) / max(rv[n], floor) if math.isfinite(p) else math.inf
        return out

    g = gaps(prog["first_grad"], rg, med)
    d = gaps(prog["delta"], ref["delta"], med_d)
    kept = prog.get("kept", {})
    checked = {name: (scaled_score_gap(kept[name], out, ref["kept_scales"][name])
                      if name in kept else math.inf)
               for name, out in ref["kept"].items()}
    return {**checked,
            "vtm_score_gap": (scaled_score_gap(prog["scores"], ref["scores"], ref["scales"])
                              if "scores" in prog else math.inf),
            "loss_gap": loss_gap, "grad_gap": max(g.values()), "delta_gap": max(d.values()),
            "worst_leaves": f"grad {max(g, key=g.get)}, change {max(d, key=d.get)}; "
                            f"{len(leaves)} of {len(rg)} leaves counted"}


@torch.no_grad()
def reference_eval(cell, seed: int, device, numerics: str = "fp32"):
    """The reference's stage-1 video tokens of every item and its score of
    every (caption, video) pair."""
    from portbench.reference.steps import retrieval_scores
    t, run = cell.traffic, cell.config["run"]
    model = _ref_model(cell, numerics, device)
    inputs.load_weights(model, inputs.make_weights(inputs.param_specs(model), seed, device))
    items = inputs.RetrievalItems(seed, t["captions"], t["clips"], run["size_frame"],
                                  run["size_img"], run["size_txt"],
                                  cell.config["dims"]["text"]["vocab_size"], device)
    n = t["captions"]
    ti, vj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    pairs = torch.from_numpy(np.stack([ti.ravel(), vj.ravel()], axis=1)).to(device)
    bank, scores, scales = retrieval_scores(model, items.img, items.txt, items.mask, pairs,
                                            chunk=256)
    return {"bank": bank, "scores": scores.view(n, n), "scales": scales.view(n, n)}


def eval_numbers(prog: dict, ref: dict) -> dict:
    score_gap = scaled_score_gap(prog["scores"], ref["scores"], ref["scales"])
    rb, pb = ref["bank"].float(), prog["bank"].float()
    per = (pb - rb).flatten(1).norm(dim=1) / rb.flatten(1).norm(dim=1).clamp(min=1e-30)
    bank_gap = float(per.max())
    return {"score_gap": score_gap, "bank_gap": bank_gap if math.isfinite(bank_gap) else math.inf}


def reference_numbers(cell, seed: int, device, prog: dict, numerics: str = "fp32",
                      batch_rows=None) -> dict:
    """The cell's compared numbers for the program's readings ``prog``."""
    with exact_fp32():
        if cell.traffic["entry"] == "retrieval_eval":
            return eval_numbers(prog, reference_eval(cell, seed, device, numerics))
        return train_numbers(prog, reference_train(cell, seed, device, numerics, batch_rows))


class exact_fp32:
    """TF32 off for the reference's products and convolutions."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def verdict(numbers: dict, limits: dict, failed: int) -> tuple[bool, dict]:
    """``correct`` and each number beside its limit; a limit whose number
    was not computed reads inf and fails."""
    numbers = {k: numbers.get(k, math.inf) for k in limits}
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = failed == 0 and all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
                             for k in limits)
    return ok, shown
