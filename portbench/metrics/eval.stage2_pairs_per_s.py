"""Stage 2's rate: the evaluator's own pair count over its stage-2 seconds,
summed over the window's evals."""


def read(ctx):
    w = ctx.window
    if w["kind"] != "eval" or w["stage2_s"] <= 0:
        return None
    return w["pairs"] / w["stage2_s"]
