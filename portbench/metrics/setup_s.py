"""Set-up: process start to the first timed step or eval (host clock):
imports, the kernel library's build or load, model build, the seeded
weights and inputs, and the warm-up steps or eval."""


def read(ctx):
    return ctx.setup_s
