"""The pretrain step's tail: the 90th percentile of all step times of the
window (host clock around each step and its synchronise)."""

from portbench.harness import readers


def read(ctx):
    return readers.step_ms_p90(ctx, "train")
