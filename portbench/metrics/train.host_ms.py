"""The pretrain step's host ms: the program's span ``step``, median over the
traced steps with the tracer on (``harness/spans.py``)."""

from portbench.harness import spans


def read(ctx):
    return spans.host_ms(ctx, "train", "step")
