"""Times per traced frame the host waits on the card inside the port's
`render_frame` (synchronising runtime calls in the render span; the
harness's own synchronise after it is not counted)."""


def read(ctx):
    t = ctx.trace
    return t.waits / t.frames if t else None
