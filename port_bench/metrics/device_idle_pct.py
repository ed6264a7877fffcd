"""Share of the traced window in which no device op ran."""


def read(ctx):
    t = ctx.trace
    return (1.0 - t.busy_s / t.window_s) * 100.0 if t and t.window_s > 0 else None
