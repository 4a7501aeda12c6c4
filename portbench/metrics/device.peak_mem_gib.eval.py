"""The most device memory the eval allocated in the window, GiB."""

from portbench.harness import readers


def read(ctx):
    return readers.peak_mem_gib(ctx, "eval")
