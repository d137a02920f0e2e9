"""Seconds from the start of the process to the start of the window:
imports, the kernels' build where the checkout has none, data, index
build, engine warm-up."""


def read(ctx):
    return ctx.setup_s
