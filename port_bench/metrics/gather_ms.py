"""Device ms a frame of NCCL's all-gathers of colour and hit, each read on
the rank that entered it last (sharded.py::gather_seconds): a rank that
enters early spins in the kernel until the others come, so only the last
one's kernel is the transfer itself."""


def read(ctx):
    t, s = ctx.trace, ctx.facts.get("gather_s")
    return s / t.frames * 1e3 if t and s else None
