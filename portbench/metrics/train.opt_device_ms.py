"""The device ms a pretrain step launches inside its span ``step.update``
(children included), median over the traced steps, from a profile of the host and the
device (``harness/spans.py``)."""

from portbench.harness import spans


def read(ctx):
    return spans.device_ms(ctx, "train", "step.update")
