"""Device busy ms a frame of the ops launched inside the port's span
`hmrt.shade.fog` (the distance fog's colour maths, entered only when the
configuration has fog), over the armed span ops sub-run's frames
(span_ops.py).

Retired: BENCHMARK.json no longer lists it, since the CUDA colour pass
(`shade_color_kernel`) runs the fog inside one launch and so launches no op
in the span. The reader and span_ops.py stay while the tests under tests/
that run them do."""

from port_bench import span_ops


def read(ctx):
    r = span_ops.reading(ctx)
    return r.ms("hmrt.shade.fog") if r else None
