"""The BERT fusion's self-attention in the eval, forward at p = 0 (row 5):
the least time its calls need, from the shapes, over the device time of
the kernels that do it in the profiled span, %."""

from portbench.harness import readers


def read(ctx):
    return readers.roofline(ctx, "eval", "fusion_attention_calls", readers.FUSION_ATTENTION)
