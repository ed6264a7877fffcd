"""Maximum-mipmap pyramid, flattened level-major (finest first).

Counterpart of `hmrt_tpu/core/pyramid.py`. Heights h[y, x] are CORNER
samples of an (N-1)x(N-1) cell grid; level 0 stores, per cell, the max of
its 4 corner heights, padded with NEG_INF to the next power of two M so
every level halves exactly. Flat layout:
    offset(l) = sum_{k<l} (M >> k)^2 = (M^2 - (M^2 >> 2l)) * 4 // 3
    index(l, cy, cx) = offset(l) + cy * (M >> l) + cx
"""

from __future__ import annotations

import torch

NEG_INF = -3.0e38  # sentinel for padded cells; avoids inf arithmetic traps


def next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def num_levels(m: int) -> int:
    """Levels down to 1x1 inclusive: log2(m) + 1."""
    return m.bit_length()  # m is a power of two


def flat_size(m: int) -> int:
    return (m * m * 4 - 1) // 3


def cell_maxes(heights: torch.Tensor) -> torch.Tensor:
    """Level 0: per-cell max of the 4 corner samples, (N, N) -> (N-1, N-1)."""
    return torch.maximum(torch.maximum(heights[:-1, :-1], heights[:-1, 1:]),
                         torch.maximum(heights[1:, :-1], heights[1:, 1:]))


def build_levels(heights: torch.Tensor) -> list[torch.Tensor]:
    """All pyramid levels as (M>>k, M>>k) tensors, finest first."""
    c = cell_maxes(heights)
    n_cells = c.shape[0]
    m = next_pow2(n_cells)
    cur = torch.full((m, m), NEG_INF, dtype=c.dtype, device=c.device)
    cur[:n_cells, :n_cells] = c
    levels = [cur]
    while cur.shape[0] > 1:
        s = cur.shape[0] // 2
        cur = cur.reshape(s, 2, s, 2).amax(dim=(1, 3))
        levels.append(cur)
    return levels


def build_pyramid_flat(heights: torch.Tensor) -> torch.Tensor:
    """heights (N, N) -> flat level-major max pyramid, shape (flat_size(M),)."""
    return torch.cat([lvl.reshape(-1) for lvl in build_levels(heights)])


def corner_records(heights: torch.Tensor, m: int) -> torch.Tensor:
    """Per-cell corner records, (N, N) -> contiguous (m, m, 4): record
    [cy, cx] holds (z00, z10, z01, z11) = heights[cy, cx], [cy, cx+1],
    [cy+1, cx], [cy+1, cx+1], the order the intersectors take. Cells padded
    beyond N-1 hold NEG_INF in all four slots, so the max of a record
    equals pyramid level 0 bit for bit, padding included. The CUDA march
    reads a level-0 cell's max and its exact test from one 16-byte record."""
    c = heights.shape[0] - 1
    rec = torch.full((m, m, 4), NEG_INF, dtype=heights.dtype, device=heights.device)
    for k, (y, x) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        rec[:c, :c, k] = heights[y:y + c, x:x + c]
    return rec


def flat_index(m: int, level, cy, cx):
    """Index into the flat pyramid; level/cy/cx may be int tensors."""
    mm = m * m
    off = ((mm - (mm >> (2 * level))) * 4) // 3
    row = m >> level
    return off + cy * row + cx
