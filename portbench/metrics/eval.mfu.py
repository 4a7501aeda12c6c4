"""The eval's model FLOPs (stage 1's encodes and stage 2's fusion passes,
forward only), counted from the shapes, times the window's evals, over its
seconds, % of the card's dense bf16 peak."""

from portbench.harness import readers


def read(ctx):
    return readers.mfu(ctx, "eval")
