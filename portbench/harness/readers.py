"""What the metric files share: each metric file under ``metrics/`` names
its window kind (``train``: the pretrain step; ``eval``) and, for a
roofline, its kernels, and calls one of these. Each returns None where the run has nothing to read."""

from __future__ import annotations

import numpy as np

from portbench.harness import work


def rate(ctx, kind: str, count: str):
    """``count`` (clips, pairs) of the window over its seconds."""
    w = ctx.window
    return w[count] / w["seconds"] if w["kind"] == kind else None


def step_ms_p90(ctx, kind: str):
    """The 90th percentile of all the window's step times, ms (linear
    interpolation between ranks); None under 20 steps."""
    w = ctx.window
    if w["kind"] != kind or len(w["step_s"]) < 20:
        return None
    return float(np.percentile(np.asarray(w["step_s"]) * 1e3, 90))


def mfu(ctx, kind: str):
    """Model FLOPs of the window's work over its seconds, % of the card's
    dense bf16 peak."""
    w = ctx.window
    if w["kind"] != kind or ctx.peaks is None:
        return None
    return 100.0 * w["flops"] / w["seconds"] / ctx.peaks["flops"]


def roofline(ctx, kind: str, calls_of: str, kernels):
    """Least time of the profiled span's calls (``ctx.entry.<calls_of>``)
    over the device time of ``kernels`` in it, %."""
    t = ctx.trace
    if ctx.window["kind"] != kind or t is None or ctx.peaks is None:
        return None
    done = next(iter(ctx.trace_counts.values()))
    calls = getattr(ctx.entry, calls_of)(done)
    device_s = t.seconds_matching(kernels)
    if not calls or device_s <= 0:
        return None
    return 100.0 * work.least_seconds(calls, ctx.peaks["flops"], ctx.peaks["bytes"]) / device_s


def idle_share(ctx, kind: str):
    t = ctx.trace
    if ctx.window["kind"] != kind or t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def peak_mem_gib(ctx, kind: str):
    if ctx.window["kind"] != kind or ctx.peak_bytes <= 0:
        return None
    return ctx.peak_bytes / 2 ** 30


# the symbols of the kernels that do each attention's work (``csrc/``)
WINDOW_ATTENTION = ("direct_window_attention_fwd_kernel", "direct_window_attention_bwd_kernel",
                    "sum_slices_kernel")
FUSION_ATTENTION = ("sa_fwd_mma_kernel", "sa_bwd_rows_mma_kernel", "sa_bwd_cols_mma_kernel",
                    "lane_self_attention_fwd_kernel", "lane_self_attention_bwd_rows_kernel",
                    "lane_self_attention_bwd_cols_kernel")
