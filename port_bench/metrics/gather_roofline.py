"""The all-gather's least time over its device time, in %.

The least time is the bytes one card must receive in a frame's gathers,
every other card's bands of colour and hit (roofline.py::gather_bytes),
over one card's NVLink peak in one direction. The device time is
`gather_ms`'s: each all-gather on the rank that entered it last. On cards
linked only by PCIe the share reads low, never high."""

from port_bench.roofline import NVLINK_BYTES_PER_S, gather_bytes


def read(ctx):
    t, s = ctx.trace, ctx.facts.get("gather_s")
    chips = ctx.facts.get("chips", 1)
    if not t or not s or chips < 2:
        return None
    return gather_bytes(ctx.config["render"], chips) / NVLINK_BYTES_PER_S / (s / t.frames) * 100.0
