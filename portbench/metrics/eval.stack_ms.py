"""The host ms an eval spends in its spans ``eval.stack`` (stage 1's
``torch.stack`` of the host's items), mean over the traced evals (``harness/spans.py``)."""

from portbench.harness import spans


def read(ctx):
    return spans.host_ms(ctx, "eval", "eval.stack")
