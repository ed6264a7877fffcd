"""Device ms per traced frame of the port's own kernels (K1 march_pass,
K2 shade_pass, K3 render_tile)."""

from port_bench.trace import PORT_KERNELS


def read(ctx):
    t = ctx.trace
    if not t:
        return None
    s = t.op_seconds(lambda name: name.startswith(PORT_KERNELS))
    return s / t.frames * 1e3 if s else None
