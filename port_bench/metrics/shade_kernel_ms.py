"""Device ms per traced frame of the shade pass K2 (`shade_pass_kernel`,
either instance: `<true>` textured, `<false>` not), in the unarmed traced
sub-run."""

KERNEL = "shade_pass_kernel"


def read(ctx):
    t = ctx.trace
    if not t:
        return None
    s = t.op_seconds(lambda name: name.startswith(KERNEL))
    return s / t.frames * 1e3 if s else None
