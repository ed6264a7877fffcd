"""Process start to the first timed frame (host clock): the inputs, the
scene build, the kernels' load (and build, on a checkout's first run),
the cameras and the warm-up frames."""


def read(ctx):
    return ctx.facts["setup_s"]
