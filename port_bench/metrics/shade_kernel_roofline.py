"""The shade pass K2's least time over its device time, in %.

The least time is the bytes K2 cannot avoid (kernel_bytes.py: each lane's
planes in and out, each hit's shade record and, where textured, its albedo
record) over the card's peak bandwidth (roofline.py), for a launch over
the frame's width x height lanes with the traced frames' mean hit pixels.
The device time is the mean of K2's launches in the unarmed traced
sub-run, one a frame."""

import numpy as np

from port_bench.kernel_bytes import shade_pass_bytes
from port_bench.roofline import HBM_BYTES_PER_S

KERNEL = "shade_pass_kernel"


def read(ctx):
    t = ctx.trace
    hits = ctx.facts.get("traced_hit_pixels")
    if not t or not hits:
        return None
    times = [s for name, s in t.ops if name.startswith(KERNEL)]
    if not times or sum(times) <= 0:
        return None
    render = ctx.config["render"]
    lanes = int(render["width"]) * int(render["height"])
    least = shade_pass_bytes(lanes, float(np.mean(hits)), bool(render["texture"])) / HBM_BYTES_PER_S
    return least / float(np.mean(times)) * 100.0
