"""Synchronising calls inside the pretrain step's span ``step``: the program's
``syncs`` counter (CUDA's sync debug mode while the tracer records), median over the
traced steps (``harness/spans.py``)."""

from portbench.harness import spans


def read(ctx):
    return spans.counter(ctx, "train", "syncs")
