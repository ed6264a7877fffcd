"""Peaks of the card and the bytes a frame cannot avoid.

HBM bandwidth of one NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet,
at its 700 W power limit; a run prints the card's power limit beside any
share of it. NVLink: the same card's 18 fourth-generation links at 25 GB/s
each in one direction, what one card can receive.
"""

HBM_BYTES_PER_S = 3.35e12
NVLINK_BYTES_PER_S = 450e9


def frame_bytes(render: dict, hit_pixels: int) -> int:
    """Bytes a frame of the render settings must move: the framebuffer
    written once and each hit's cell read once (4 corner heights, and 12
    corner albedo values where textured)."""
    px = int(render["width"]) * int(render["height"])
    per_px = 3 * 4 + 1 + ((4 + 3 * 4) if render.get("aux_buffers") else 0)
    per_hit = 4 * 4 + (12 * 4 if render.get("texture") else 0)
    return px * per_px + hit_pixels * per_hit


def gather_bytes(render: dict, chips: int) -> int:
    """Bytes one card must receive in a frame's all-gathers when `chips`
    cards each render a band of its rows: every other card's bands of the
    framebuffer (colour f32 x 3 and the hit byte per pixel)."""
    px = int(render["width"]) * int(render["height"])
    return px * (3 * 4 + 1) * (chips - 1) // chips
