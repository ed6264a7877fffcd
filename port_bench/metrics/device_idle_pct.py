"""Share of the traced window in which no device op ran. On several cards
the pacing rank's, whose all-gather kernels' spin while they wait for the
other ranks counts as idle (sharded.py::trace_facts)."""


def read(ctx):
    t = ctx.trace
    if not t or t.window_s <= 0:
        return None
    return (1.0 - ctx.facts.get("device_busy_s", t.busy_s) / t.window_s) * 100.0
