"""The device's idle share of the profiled span of the pretrain step: 1 -
(the union of the device's busy intervals / the span), %."""

from portbench.harness import readers


def read(ctx):
    return readers.idle_share(ctx, "train")
