"""Device busy ms a frame of the ops launched inside the port's span
`hmrt.shade.fog` (the distance fog's colour maths, entered only when the
configuration has fog), over the armed span ops sub-run's frames
(span_ops.py)."""

from port_bench import span_ops


def read(ctx):
    r = span_ops.reading(ctx)
    return r.ms("hmrt.shade.fog") if r else None
