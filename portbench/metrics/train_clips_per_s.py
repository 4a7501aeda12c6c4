"""Pretrain throughput: every clip stepped in the window over the window's
seconds, each step ended by a device synchronise (host clock)."""

from portbench.harness import readers


def read(ctx):
    return readers.rate(ctx, "train", "clips")
