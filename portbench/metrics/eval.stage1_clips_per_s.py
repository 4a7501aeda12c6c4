"""Stage 1's rate: the evaluator's own clip count over its stage-1 seconds
(each ending in a device synchronise), summed over the window's evals."""


def read(ctx):
    w = ctx.window
    if w["kind"] != "eval" or w["stage1_s"] <= 0:
        return None
    return w["clips"] / w["stage1_s"]
