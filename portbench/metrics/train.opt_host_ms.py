"""The host ms of the pretrain step's span ``step.update``, median over the
traced steps with the tracer on (``harness/spans.py``)."""

from portbench.harness import spans


def read(ctx):
    return spans.host_ms(ctx, "train", "step.update")
