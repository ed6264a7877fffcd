"""Conservative cone-ratio field for multi-cell steps on grazing rays.

Counterpart of `hmrt_tpu/core/cone.py`. Per height SAMPLE (i, j) the field
holds the smallest cone opening ratio

    c(i, j) = max_{0 < chebdist((u,v),(i,j)) <= R} (H[u,v] - H[i,j]) / chebdist

so that no sample within Chebyshev radius R pokes above the cone
z = H[i,j] + c(i,j) * d. A ray at height z leaving a level-0 cell whose low
corner (the apex) has height H0 and cone c can advance

    u_max = (z - H0 - 2c) / (c - g)        [g = dz per Chebyshev cell]

Chebyshev cells without meeting the surface (+1 for the ray's offset in the
cell, +1 for the cell's far corners; both intersectors' surfaces lie under
their cell's max corner). `traversal/march.py::maxmip_step` jumps
floor(u_max) - 1 cells, a whole cell of margin over the f32 rounding of the
bound, so hit decisions are those of the march without it
(tests/test_torch_cone.py holds it against brute-force DDA).

The field is R rounds of a 3x3 max-dilation with a -inf border (radius-d
Chebyshev dilation is d rounds of 3x3), each divided by its round index.
No render path uses it: on fBm terrain the jump fires on ~0% of level-0
steps (the JAX package's measured result), and it stays plain torch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CONE_RADIUS = 64  # default Chebyshev validity radius of the cone field


def build_cone(heights: torch.Tensor, radius: int = CONE_RADIUS) -> torch.Tensor:
    """Conservative cone ratios c >= 0 per sample, valid within `radius`.

    heights: (n, n) f32 sample grid. Returns (n, n) f32 with
    H[u,v] <= H[i,j] + c[i,j] * chebdist for every sample within radius.
    `max_pool2d` pads its window with -inf, the JAX package's border."""
    h = heights.to(torch.float32)
    w = h
    c = torch.zeros_like(h)
    for d in range(1, radius + 1):
        w = F.max_pool2d(w[None, None], kernel_size=3, stride=1, padding=1)[0, 0]
        c = torch.maximum(c, (w - h) / torch.tensor(float(d), dtype=torch.float32,
                                                    device=h.device))
    return c


def cone_safe_cells(z_exit, apex_h, cone, g_cheb, radius: int):
    """Safe whole-cell jump count for rays leaving a level-0 cell.

    z_exit: ray height at the cell's exit; apex_h: the cell's low corner
    sample height (z00); cone: that sample's ratio; g_cheb: ray dz per
    Chebyshev cell (signed). Returns int32 >= 0; a jump of k cells is exact
    for k >= 2 (callers take the normal single step below 2)."""
    num = z_exit - apex_h - 2.0 * cone
    den = cone - g_cheb
    big = torch.full_like(num, 3.4e38)
    u = torch.where(den > 1e-12, num / den, torch.where(num > 0.0, big, 0.0))
    # clamp before converting (defined for every value): any floor above
    # `radius` ends at radius - 2 below, as the JAX conversion's saturation does
    kf = torch.clamp(torch.floor(torch.clamp_max(u, 3.0e38)), -1.0, float(radius))
    return torch.clamp(kf.to(torch.int32) - 1, 0, radius - 2)
