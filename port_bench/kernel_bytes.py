"""Bytes a kernel of the port cannot avoid, counted from what it is asked
to do, so that the count reads the same work whatever implements it.

The shade pass (K2, `hmrt_tpu_torch/kernels/shade_pass.py`): for each lane
it reads the hit, hx and hy planes (3 x 4 B) and the in-cell offsets fx,
fy (2 x 4 B) and writes the normal and the albedo (6 x 4 B); for each hit
lane it reads its cell's shade record (4 corners x 2 gradients x 4 B) and,
where textured, its albedo record (4 corners x 3 channels x 4 B).
"""

LANE_BYTES = 3 * 4 + 2 * 4 + 6 * 4
SHADE_RECORD_BYTES = 4 * 2 * 4
ALBEDO_RECORD_BYTES = 4 * 3 * 4


def shade_pass_bytes(lanes: int, hits: float, textured: bool) -> float:
    """Bytes of one shade pass over `lanes` lanes of which `hits` hit."""
    per_hit = SHADE_RECORD_BYTES + (ALBEDO_RECORD_BYTES if textured else 0)
    return lanes * LANE_BYTES + hits * per_hit
