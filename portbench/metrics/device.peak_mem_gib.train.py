"""The most device memory the pretrain step allocated in the window
(``max_memory_allocated`` after ``reset_peak_memory_stats`` at its start),
GiB."""

from portbench.harness import readers


def read(ctx):
    return readers.peak_mem_gib(ctx, "train")
