"""The frame's least time over its device busy time, bound by bytes.

The least time is the bytes no implementation of the frame can avoid over
the peak bandwidth of the cards that render it (roofline.py): the
framebuffer written once (colour f32 x 3 and the hit byte per pixel, depth
and normals where the configuration has aux buffers) and, for each hit
pixel, its hit cell's 4 corner heights and, where textured, its 12 corner
albedo values. The hit pixels are counted from the traced frames' (on
several cards, gathered) hit masks. On several cards the peak is the
cards' together and the busy time the pacing rank's without the spin of
its all-gather kernels (sharded.py::trace_facts). It reads the same work
whatever implements the march."""

from port_bench.roofline import HBM_BYTES_PER_S, frame_bytes


def read(ctx):
    t = ctx.trace
    hits = ctx.facts.get("traced_hit_pixels")
    busy = ctx.facts.get("device_busy_s", t.busy_s) if t else 0.0
    if not hits or busy <= 0:
        return None
    peak = HBM_BYTES_PER_S * ctx.facts.get("chips", 1)
    least = sum(frame_bytes(ctx.config["render"], h) for h in hits) / peak
    return least / busy * 100.0
