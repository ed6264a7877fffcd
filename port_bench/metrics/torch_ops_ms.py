"""Device ms per traced frame of every device op that is not one of the
port's kernels: torch's sorts, gathers, scatters, elementwise maths,
copies and memsets. NCCL's all-gathers between cards are not counted
(`gather_ms` reads them)."""

from port_bench.trace import GATHER, PORT_KERNELS


def read(ctx):
    t = ctx.trace
    if not t:
        return None
    s = t.op_seconds(lambda name: not name.startswith(PORT_KERNELS) and GATHER not in name)
    return s / t.frames * 1e3 if s else None
