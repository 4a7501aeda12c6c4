"""The student Video Swin's window attention in the pretrain step, forward
and backward (rows 3-4, ``csrc/window_attention.cu``): the least time its
calls need, from the shapes (``harness/work.py``: max(ops / peak, bytes /
bandwidth) a call, the backward 2.5x the forward's ops), over the device
time of the kernels that do it in the profiled span, %."""

from portbench.harness import readers


def read(ctx):
    return readers.roofline(ctx, "train", "window_attention_calls", readers.WINDOW_ATTENTION)
