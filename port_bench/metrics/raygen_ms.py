"""Device ms a frame (busy and idle) charged to the port's raygen span,
`hmrt.raygen`: the primary rays and their start state (stages.py, the
armed spans sub-run)."""

from port_bench import stages


def read(ctx):
    r = stages.reading(ctx)
    return r.ms("raygen") if r else None
