"""Frames completed in the window over the window's seconds (host clock):
what a flythrough writer or a batch renderer pays."""


def read(ctx):
    return len(ctx.frame_s) / ctx.window_s if ctx.frame_s else None
