"""The frozen MVM teacher's device ms for one no-grad call on one batch's
normalized clips (CUDA events around the call, after one call of the same
shapes), timed from outside the step after the profiled span."""


def read(ctx):
    return ctx.teacher_ms
