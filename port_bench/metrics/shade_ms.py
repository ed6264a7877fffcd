"""Device ms a frame (busy and idle) charged to `hmrt.shade` outside
`hmrt.shadow`: hit points, the shade kernel, the colour maths and the
frame (stages.py, the armed spans sub-run)."""

from port_bench import stages


def read(ctx):
    r = stages.reading(ctx)
    return r.ms("shade") if r else None
