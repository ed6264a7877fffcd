"""The frame's least time over its device busy time, bound by bytes.

The least time is the bytes no implementation of the frame can avoid over
the card's peak bandwidth (roofline.py): the framebuffer written once
(colour f32 x 3 and the hit byte per pixel, depth and normals where the
configuration has aux buffers) and, for each hit pixel, its hit cell's 4
corner heights and, where textured, its 12 corner albedo values. The hit
pixels are counted from the traced frames' hit masks. It reads the same
work whatever implements the march."""

from port_bench.roofline import HBM_BYTES_PER_S, frame_bytes


def read(ctx):
    t = ctx.trace
    hits = ctx.facts.get("traced_hit_pixels")
    if not t or not hits or t.busy_s <= 0:
        return None
    least = sum(frame_bytes(ctx.config["render"], h) for h in hits) / HBM_BYTES_PER_S
    return least / t.busy_s * 100.0
