"""The pretrain step's model FLOPs (forward and backward of the trained
parts, 3x the forward's matrix products, and the frozen teacher's forward;
no recomputation), counted from the shapes (``harness/work.py``), times the
window's steps, over its seconds, % of the card's dense bf16 peak."""

from portbench.harness import readers


def read(ctx):
    return readers.mfu(ctx, "train")
