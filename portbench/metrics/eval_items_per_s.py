"""Eval throughput: the scored (caption, video) pairs of every whole eval
of the window over the seconds from the window's start to the end of the
last eval (host clock; the evaluator ends each stage in a synchronise)."""

from portbench.harness import readers


def read(ctx):
    return readers.rate(ctx, "eval", "pairs")
