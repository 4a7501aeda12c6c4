"""The BERT fusion's self-attention in the pretrain step, forward and backward
(rows 5-6, ``csrc/self_attention.cu`` on ``csrc/self_attention_mma.cuh``):
the least time its calls need, from the shapes, over the device time of
the kernels that do it in the profiled span, %."""

from portbench.harness import readers


def read(ctx):
    return readers.roofline(ctx, "train", "fusion_attention_calls", readers.FUSION_ATTENTION)
