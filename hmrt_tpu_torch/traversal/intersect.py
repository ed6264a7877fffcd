"""Exact ray/cell intersection at the finest level.

Counterpart of `hmrt_tpu/traversal/intersect.py`, in the same float order
of operations, so hit decisions match the JAX package bit for bit (the
CUDA march kernel, `kernels/csrc/march_pass.cu`, repeats these lines):

  - "triangle": two triangles per cell, split along the (10)-(01) diagonal
  - "bilinear": the bilinear patch z = a + b*u + c*v + d*u*v (quadratic in t)
  - "flat":     a flat column top at the cell's max corner height

Cell (cx, cy) spans x in [cx, cx+1], y in [cy, cy+1]; corner heights
z00=h[cy,cx], z10=h[cy,cx+1] (x+), z01=h[cy+1,cx] (y+), z11=h[cy+1,cx+1].
"""

from __future__ import annotations

import torch

BIG_T = 3.0e38


def _safe(x):
    """x with magnitudes below 1e-20 replaced by 1e-20 (a safe divisor)."""
    return torch.where(torch.abs(x) < 1e-20, 1e-20, x)


def intersect_triangles(ox, oy, oz, dx, dy, dz, cx, cy,
                        z00, z10, z01, z11, t_lo, t_hi):
    """Ray vs the two cell triangles T1 = (c00, c10, c01) and
    T2 = (c11, c01, c10): solve each plane for t, then test barycentric
    containment in cell-local (u, v). Returns (hit, t)."""
    fx = cx.to(torch.float32)
    fy = cy.to(torch.float32)
    g1x = z10 - z00
    g1y = z01 - z00
    denom1 = dz - g1x * dx - g1y * dy
    num1 = z00 + g1x * (ox - fx) + g1y * (oy - fy) - oz
    t1 = num1 / _safe(denom1)
    u1 = ox + t1 * dx - fx
    v1 = oy + t1 * dy - fy
    eps = 1e-6
    in1 = (u1 >= -eps) & (v1 >= -eps) & (u1 + v1 <= 1.0 + eps)
    ok1 = in1 & (t1 >= t_lo) & (t1 <= t_hi)

    # plane through (1,0,z10), (0,1,z01), (1,1,z11):
    #   z = (z10 - z11 + z01) + (z11 - z01)*u + (z11 - z10)*v
    a2 = z10 - z11 + z01
    g2x = z11 - z01
    g2y = z11 - z10
    denom2 = dz - g2x * dx - g2y * dy
    num2 = a2 + g2x * (ox - fx) + g2y * (oy - fy) - oz
    t2 = num2 / _safe(denom2)
    u2 = ox + t2 * dx - fx
    v2 = oy + t2 * dy - fy
    in2 = (u2 <= 1.0 + eps) & (v2 <= 1.0 + eps) & (u2 + v2 >= 1.0 - eps)
    ok2 = in2 & (t2 >= t_lo) & (t2 <= t_hi)

    t = torch.minimum(torch.where(ok1, t1, BIG_T), torch.where(ok2, t2, BIG_T))
    return ok1 | ok2, t


def intersect_bilinear(ox, oy, oz, dx, dy, dz, cx, cy,
                       z00, z10, z01, z11, t_lo, t_hi):
    """Ray vs bilinear patch: solve the quadratic in t; returns (hit, t)."""
    fx = cx.to(torch.float32)
    fy = cy.to(torch.float32)
    b = z10 - z00
    c = z01 - z00
    e = z11 - z10 - z01 + z00
    u0 = ox - fx
    v0 = oy - fy
    # A t^2 + B t + C = 0 with u = u0 + t*dx, v = v0 + t*dy
    A = -e * dx * dy
    B = dz - b * dx - c * dy - e * (u0 * dy + v0 * dx)
    C = oz - z00 - b * u0 - c * v0 - e * u0 * v0
    lin_t = -C / _safe(B)
    disc = B * B - 4.0 * A * C
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    q = -0.5 * (B + torch.sign(B) * sq)   # numerically stable root pair
    r1 = q / _safe(A)
    r2 = C / _safe(q)
    tmin = torch.minimum(r1, r2)
    tmax = torch.maximum(r1, r2)
    is_lin = torch.abs(A) < 1e-12
    eps = 1e-6

    def valid_lin(t):
        u = u0 + t * dx
        v = v0 + t * dy
        inside = (u >= -eps) & (u <= 1.0 + eps) & (v >= -eps) & (v <= 1.0 + eps)
        return inside & (t >= t_lo) & (t <= t_hi)

    def valid(t):
        return valid_lin(t) & (disc >= 0.0)

    c1 = (is_lin & valid_lin(lin_t)) | (~is_lin & valid(tmin))
    c2 = ~is_lin & valid(tmax)
    tq = torch.where(valid(tmin), tmin, torch.where(valid(tmax), tmax, BIG_T))
    t = torch.where(is_lin, torch.where(valid_lin(lin_t), lin_t, BIG_T), tq)
    return c1 | c2, t


def intersect_flat(ox, oy, oz, dx, dy, dz, cx, cy,
                   z00, z10, z01, z11, t_lo, t_hi):
    """Ray vs flat column top at the cell max height: a wall hit when the
    ray enters the cell below the top, else a top-face hit descending onto
    it inside [t_lo, t_hi]. Returns (hit, t)."""
    zmax = torch.maximum(torch.maximum(z00, z10), torch.maximum(z01, z11))
    wall = oz + t_lo * dz <= zmax
    t_top = (zmax - oz) / _safe(dz)
    top = (dz < 0.0) & (t_top >= t_lo) & (t_top <= t_hi)
    return wall | top, torch.where(wall, t_lo, t_top)


INTERSECTORS = {
    "triangle": intersect_triangles,
    "bilinear": intersect_bilinear,
    "flat": intersect_flat,
}

#: the integer the CUDA march kernel selects its intersector by
INTERSECTOR_IDS = {"triangle": 0, "bilinear": 1, "flat": 2}


# Point evaluation of the SAME cell surface each intersector tests against,
# for the relaxed stride tail (traversal/march.py::l0_step_relaxed): a sample
# point below surface_*() implies, by continuity of the piecewise surface, a
# crossing between the last sample above and this one, so the exact walk over
# that bracket (the matching intersect_*() in every cell) finds a hit. An
# evaluator is never paired with another kind's intersector. The expressions
# are those of `hmrt_tpu/traversal/intersect.py`, in the same order.

def surface_triangle(u, v, z00, z10, z01, z11):
    """Height of the two-triangle cell surface at local (u, v): the planes of
    intersect_triangles, split along the (10)-(01) diagonal."""
    zl = z00 + (z10 - z00) * u + (z01 - z00) * v
    zu = (z10 - z11 + z01) + (z11 - z01) * u + (z11 - z10) * v
    return torch.where(u + v <= 1.0, zl, zu)


def surface_bilinear(u, v, z00, z10, z01, z11):
    """Height of the bilinear patch at local (u, v)."""
    b = z10 - z00
    c = z01 - z00
    e = z11 - z10 - z01 + z00
    return z00 + b * u + c * v + e * u * v


def surface_flat(u, v, z00, z10, z01, z11):
    """Height of the flat column top: the cell's max corner height."""
    return torch.maximum(torch.maximum(z00, z10), torch.maximum(z01, z11))


SURFACES = {
    "triangle": surface_triangle,
    "bilinear": surface_bilinear,
    "flat": surface_flat,
}
