"""The host ms an eval spends in its spans ``eval.h2d`` (stage 1's copies of
the stacked items to the card), mean over the traced evals (``harness/spans.py``)."""

from portbench.harness import spans


def read(ctx):
    return spans.host_ms(ctx, "eval", "eval.h2d")
