"""Kernel launches per traced frame (device kernels in the traced window)."""


def read(ctx):
    t = ctx.trace
    return t.kernels / t.frames if t and t.kernels else None
