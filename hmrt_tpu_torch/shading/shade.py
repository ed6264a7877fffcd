"""Shading: gradient normals, Lambert/Phong, fog, sky, texture.

Counterpart of `hmrt_tpu/shading/shade.py`: plain torch over ray batches,
in the same float order of operations.
"""

from __future__ import annotations

import torch

from hmrt_tpu_torch.traversal.march import corner_heights


def _cell_and_offset(n: int, px, py):
    """Clamped integer cell of (px, py) and the offsets inside it."""
    ix = torch.clamp(torch.floor(px), 0.0, float(n - 2)).to(torch.int32)
    iy = torch.clamp(torch.floor(py), 0.0, float(n - 2)).to(torch.int32)
    return ix, iy, px - ix, py - iy


def bilerp(v00, v10, v01, v11, fx, fy):
    """Bilinear interpolation of 4 corner values at in-cell (fx, fy)."""
    return (v00 * (1 - fx) * (1 - fy) + v10 * fx * (1 - fy)
            + v01 * (1 - fx) * fy + v11 * fx * fy)


def gradient_normal(heights_flat, n: int, px, py):
    """World-space surface normal from central differences of the height
    grid, bilinearly interpolated at (px, py): normalize(-gx, -gy, 1),
    corners clamped at the border."""
    ix, iy, fx, fy = _cell_and_offset(n, px, py)

    def take(i):
        return heights_flat.index_select(0, i)

    def grad_at(cx, cy):
        xm = torch.clamp(cx - 1, 0, n - 1)
        xp = torch.clamp(cx + 1, 0, n - 1)
        ym = torch.clamp(cy - 1, 0, n - 1)
        yp = torch.clamp(cy + 1, 0, n - 1)
        gx = (take(cy * n + xp) - take(cy * n + xm)) * torch.where(
            (xp - xm) > 0, 1.0 / (xp - xm).to(torch.float32), 0.0)
        gy = (take(yp * n + cx) - take(ym * n + cx)) * torch.where(
            (yp - ym) > 0, 1.0 / (yp - ym).to(torch.float32), 0.0)
        return gx, gy

    g00x, g00y = grad_at(ix, iy)
    g10x, g10y = grad_at(ix + 1, iy)
    g01x, g01y = grad_at(ix, iy + 1)
    g11x, g11y = grad_at(ix + 1, iy + 1)
    gx = bilerp(g00x, g10x, g01x, g11x, fx, fy)
    gy = bilerp(g00y, g10y, g01y, g11y, fx, fy)
    inv = torch.rsqrt(gx * gx + gy * gy + 1.0)
    return -gx * inv, -gy * inv, inv


def sample_height(heights_flat, n: int, px, py):
    """Bilinear height sample at (px, py), the cell clamped to the map."""
    ix, iy, fx, fy = _cell_and_offset(n, px, py)
    return bilerp(*corner_heights(heights_flat, n, ix, iy), fx, fy)


def sample_albedo(albedo_flat, n: int, px, py):
    """Bilinear RGB albedo sample; albedo_flat is planar (3, N*N)."""
    ix, iy, fx, fy = _cell_and_offset(n, px, py)
    base = iy * n + ix
    out = []
    for c in range(3):
        ch = albedo_flat[c]
        out.append(bilerp(ch.index_select(0, base), ch.index_select(0, base + 1),
                          ch.index_select(0, base + n),
                          ch.index_select(0, base + n + 1), fx, fy))
    return out  # [r, g, b] each f32[P]


def lambert(nx, ny, nz, lx, ly, lz):
    """N.L diffuse factor, clamped at 0."""
    return torch.clamp_min(nx * lx + ny * ly + nz * lz, 0.0)


def phong_specular(nx, ny, nz, lx, ly, lz, vx, vy, vz, shininess):
    """Phong specular: R = 2(N.L)N - L; max(R.V, 0)^shininess, where V
    points from the surface toward the eye."""
    ndl = nx * lx + ny * ly + nz * lz
    rx = 2.0 * ndl * nx - lx
    ry = 2.0 * ndl * ny - ly
    rz = 2.0 * ndl * nz - lz
    rdv = torch.clamp_min(rx * vx + ry * vy + rz * vz, 0.0)
    return torch.where(ndl > 0.0, rdv ** shininess, 0.0)


def sky_color(dz, sky_top, sky_horizon):
    """Vertical-gradient sky (dz = ray dir z); returns (r, g, b) f32[P]."""
    u = torch.clamp(dz, 0.0, 1.0) ** 0.5
    return tuple(sky_horizon[c] * (1.0 - u) + sky_top[c] * u for c in range(3))


def apply_fog(r, g, b, t, fog_density, fog_color):
    """Exponential distance fog."""
    f = torch.exp(-t * fog_density)
    return (r * f + fog_color[0] * (1 - f),
            g * f + fog_color[1] * (1 - f),
            b * f + fog_color[2] * (1 - f))
