"""Scene construction on the card, or on the device the caller names.

Counterpart of `hmrt_tpu/api/scene.py`: upload the height grid, build the
max pyramid there (and the min pyramid the CUDA level-0 tail reads),
precompute the per-sample gradient planes, and pack the per-cell shade
records that the shade kernel reads. Everything stays resident across
frames.
"""

from __future__ import annotations

import numpy as np
import torch

from hmrt_tpu_torch.core.pyramid import (build_min_pyramid_flat, build_pyramid_flat,
                                         corner_records, next_pow2, num_levels)
from hmrt_tpu_torch.device import resolve
from hmrt_tpu_torch.types import Camera, Light, Scene
from hmrt_tpu_torch.utils.profiling import span


def corner_grads(heights: torch.Tensor):
    """Per-sample central-difference gradients with clamped borders,
    (N, N) -> (gx, gy): gx[y, x] = (h[y, x+1] - h[y, x-1]) / 2, one-sided
    (divided by 1) at the border. Same expression as the JAX package's
    `kernels/packing.py::_corner_grads`."""
    n = heights.shape[0]
    idx = torch.arange(n, device=heights.device)
    xm = torch.clamp(idx - 1, 0, n - 1)
    xp = torch.clamp(idx + 1, 0, n - 1)
    denom = (xp - xm).to(torch.float32)
    gx = (heights[:, xp] - heights[:, xm]) / denom[None, :]
    gy = (heights[xp, :] - heights[xm, :]) / denom[:, None]
    return gx.contiguous(), gy.contiguous()


def shade_records(gx: torch.Tensor, gy: torch.Tensor, albedo: torch.Tensor | None):
    """Per-cell records of what a hit in the cell shades from, over the
    C = N-1 cells a side: (shade_rec, albedo_rec).

    shade_rec, contiguous f32 (C, C, 8): cell [cy, cx] holds the gradients
    at its corners, g00x, g10x, g01x, g11x, g00y, g10y, g01y, g11y, where
    g10 is sample [cy, cx+1] and g01 sample [cy+1, cx] (the channel order
    of the JAX package's `kernels/packing.py` shade bricks). albedo_rec,
    contiguous f32 (C, C, 12) or None: r00, r10, r01, r11, g00, ..., b11 of
    the planar (3, N*N) albedo, in the order of its albedo bricks. The
    values are copies of the planes' values: nothing is rounded.

    A record is 32 (or 48) bytes, so the shade kernel reads a hit's data
    as 2 (or 3) 16-byte loads from one (or two) 32-byte sectors, instead
    of 4-byte loads from two rows of each of 2 (or 5) planes."""
    n = gx.shape[0]
    c = n - 1
    corners = ((slice(0, c), slice(0, c)), (slice(0, c), slice(1, n)),
               (slice(1, n), slice(0, c)), (slice(1, n), slice(1, n)))

    def pack(planes):
        return torch.stack([p[ys, xs] for p in planes for ys, xs in corners], dim=-1)

    albedo_rec = None if albedo is None else pack(albedo.reshape(3, n, n).unbind(0))
    return pack((gx, gy)), albedo_rec


def _planar_albedo(albedo, n: int, device) -> torch.Tensor:
    a = np.asarray(albedo, np.float32)
    if a.shape != (n, n, 3):
        raise ValueError(f"albedo must be (N, N, 3), got {a.shape}")
    return torch.from_numpy(a.reshape(n * n, 3).T.copy()).to(device)


def make_scene(heights, albedo=None, light: Light | None = None,
               device=None) -> Scene:
    """Build a Scene on `device` (default: the CUDA card) from an (N, N)
    height grid.

    `albedo` is an optional (N, N, 3) float [0,1] texture, stored planar
    (3, N*N). Spans "hmrt.scene", and inside it "hmrt.scene.pyramids" (max
    and min pyramids, corner records) and "hmrt.scene.records" (gradients,
    shade and albedo records)."""
    h = np.asarray(heights, np.float32)
    if h.ndim != 2 or h.shape[0] != h.shape[1]:
        raise ValueError(f"heights must be square (N, N), got {h.shape}")
    n = int(h.shape[0])
    if n < 2:
        raise ValueError("heightmap must be at least 2x2")
    device = resolve(device)
    m = next_pow2(n - 1)
    with span("hmrt.scene"):
        ht = torch.from_numpy(np.ascontiguousarray(h)).to(device)
        with span("hmrt.scene.pyramids"):
            pyr_flat, pyr_min_flat = build_pyramid_flat(ht), build_min_pyramid_flat(ht)
            corners = corner_records(ht, m)
        with span("hmrt.scene.records"):
            gx, gy = corner_grads(ht)
            alb = None if albedo is None else _planar_albedo(albedo, n, device)
            shade_rec, albedo_rec = shade_records(gx, gy, alb)
        return Scene(heights=ht, pyr_flat=pyr_flat, pyr_min_flat=pyr_min_flat,
                     corners=corners, albedo=alb,
                     light=light if light is not None else Light.create(device=device),
                     gx=gx, gy=gy, shade_rec=shade_rec, albedo_rec=albedo_rec, n=n, m=m,
                     levels=num_levels(m))


def _tensor(a, device):
    return torch.from_numpy(np.array(a, np.float32, copy=True)).to(device)


def scene_from_arrays(heights, pyr_flat, albedo, light: dict, *, n: int,
                      m: int, levels: int, device=None) -> Scene:
    """A Scene from the numpy arrays of another package's scene (heights,
    flat pyramid, planar albedo or None, and a dict of the light's five
    vectors), so both packages render the very same state. The min
    pyramid, which the other package does not have, is built here."""
    device = resolve(device)
    ht = _tensor(heights, device)
    if ht.shape != (n, n):
        raise ValueError(f"heights must be ({n}, {n}), got {tuple(ht.shape)}")
    gx, gy = corner_grads(ht)
    alb = None if albedo is None else _tensor(albedo, device)
    shade_rec, albedo_rec = shade_records(gx, gy, alb)
    return Scene(heights=ht, pyr_flat=_tensor(pyr_flat, device),
                 pyr_min_flat=build_min_pyramid_flat(ht), corners=corner_records(ht, m),
                 albedo=alb,
                 light=Light(**{k: _tensor(light[k], device) for k in
                                ("sun_dir", "sun_color", "sky_top",
                                 "sky_horizon", "fog_color")}),
                 gx=gx, gy=gy, shade_rec=shade_rec, albedo_rec=albedo_rec, n=n, m=m,
                 levels=levels)


def camera_from_arrays(eye, target, up, fov_y, device=None) -> Camera:
    """A Camera from numpy arrays; `fov_y` is in radians."""
    device = resolve(device)
    return Camera(eye=_tensor(eye, device), target=_tensor(target, device),
                  up=_tensor(up, device), fov_y=_tensor(fov_y, device))
