"""Core types: Camera, Light, Scene, Frame as dataclasses of torch tensors.

Counterpart of `hmrt_tpu/types.py`. World convention: the heightmap spans
x, y in [0, N-1] and z is up. Every tensor of one object lives on one
device, chosen when the object is made.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hmrt_tpu_torch.device import resolve


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of f32 `x`, the same bits on every
    device: taken in f64 and rounded once to f32 (53 >= 2*24 + 2 bits, so
    the double rounding is exact). It is what torch's f32 `sqrt` gives on
    CUDA and `sqrtf` in the kernels (built with -prec-sqrt=true); torch's
    vectorised f32 `sqrt` on the CPU is an ulp off it on some values."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _norm(v):
    """Euclidean norm over the last axis: the f32 sum of squares, x, y, z in
    that order, and its correctly rounded root (`sqrt_f32`)."""
    return sqrt_f32(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def recip_f32(k: int) -> float:
    """1/k rounded once to f32. Raygen multiplies by it instead of dividing
    by k, as XLA does with a division by a constant and as torch on CUDA
    does with a division by a Python number, so the rays are the same bits
    on every device and in the fused kernel."""
    return float(np.float32(1.0) / np.float32(k))


def tan_half(fov_y: torch.Tensor) -> torch.Tensor:
    """tan(fov_y / 2) as raygen uses it: the f32 half-angle's tan taken in
    f64 and rounded once to f32, on fov_y's device with no host copy. The
    f32 `tan` of torch differs by an ulp between the CPU and CUDA for some
    angles (60 degrees among them); this gives the same bits on both."""
    return torch.tan((fov_y * 0.5).to(torch.float64)).to(torch.float32)


def _vec3(v, device):
    return torch.as_tensor(v, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole perspective camera."""

    eye: torch.Tensor      # (3,) f32 world position
    target: torch.Tensor   # (3,) f32 look-at point
    up: torch.Tensor       # (3,) f32 up hint
    fov_y: torch.Tensor    # () f32 vertical field of view, radians

    @staticmethod
    def create(eye, target, up=(0.0, 0.0, 1.0), fov_y_deg=60.0,
               device=None) -> "Camera":
        device = resolve(device)
        return Camera(
            eye=_vec3(eye, device), target=_vec3(target, device),
            up=_vec3(up, device),
            fov_y=torch.deg2rad(torch.tensor(fov_y_deg, dtype=torch.float32,
                                             device=device)),
        )

    def basis(self):
        """Orthonormal (right, up, forward) camera basis. A forward
        direction parallel to the up hint falls back to the y axis as the
        hint, so the basis is always finite."""
        f = self.target - self.eye
        f = f / _norm(f)
        r = _cross(f, self.up)
        n2 = torch.sum(r * r)
        alt = _cross(f, torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32,
                                     device=f.device))
        r = torch.where(n2 > 1e-12, r, alt)
        r = r / _norm(r)
        u = _cross(r, f)
        return r, u, f

    def rays(self, height: int, width: int, row0: int | None = None,
             full_height: int | None = None):
        """Primary rays for every pixel: origin (3,), directions (H, W, 3).

        row0/full_height: only rows [row0, row0+height) of a
        full_height-row screen (the row-band form used under sharding)."""
        dev = self.eye.device
        r, u, f = self.basis()
        th = tan_half(self.fov_y)
        fh = height if full_height is None else full_height
        aspect = width / fh
        jj = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) \
            * recip_f32(width) * 2.0 - 1.0
        rr = torch.arange(height, dtype=torch.float32, device=dev)
        if row0 is not None:
            rr = rr + row0
        ii = 1.0 - (rr + 0.5) * recip_f32(fh) * 2.0
        dx = jj * th * aspect      # (W,)
        dy = ii * th               # (H,)
        d = (f[None, None, :]
             + dx[None, :, None] * r[None, None, :]
             + dy[:, None, None] * u[None, None, :])
        d = d / _norm(d)[..., None]
        return self.eye, d


@dataclasses.dataclass(frozen=True)
class Light:
    """Directional sun light and environment colours."""

    sun_dir: torch.Tensor      # (3,) f32, unit vector pointing TOWARD the sun
    sun_color: torch.Tensor    # (3,) f32
    sky_top: torch.Tensor      # (3,) f32 sky gradient at zenith
    sky_horizon: torch.Tensor  # (3,) f32 sky gradient at horizon
    fog_color: torch.Tensor    # (3,) f32

    @staticmethod
    def create(sun_dir=(0.4, 0.3, 0.85), sun_color=(1.0, 0.96, 0.9),
               sky_top=(0.35, 0.55, 0.95), sky_horizon=(0.75, 0.85, 0.98),
               fog_color=(0.7, 0.78, 0.88), device=None) -> "Light":
        device = resolve(device)
        d = _vec3(sun_dir, device)
        return Light(sun_dir=d / _norm(d), sun_color=_vec3(sun_color, device),
                     sky_top=_vec3(sky_top, device),
                     sky_horizon=_vec3(sky_horizon, device),
                     fog_color=_vec3(fog_color, device))


@dataclasses.dataclass(frozen=True)
class Scene:
    """Heightfield, flat max-mip pyramid, shading planes and light.

    n = height-sample grid side N; m = padded power-of-two cell-grid side;
    levels = pyramid levels (level 0 is m x m, the last is 1 x 1).
    gx, gy are the per-sample central-difference gradients (api/scene.py
    corner_grads) that the fused kernel interpolates. corners holds each
    cell's four corner heights as one record (core/pyramid.py
    corner_records), the layout the CUDA march reads level 0 from.
    pyr_min_flat is the min pyramid of the cells' lowest corners, levels
    >= 1 (core/pyramid.py build_min_pyramid_flat), which the CUDA level-0
    tail reads to pass under whole blocks.
    shade_rec and albedo_rec hold each cell's corner gradients and corner
    RGB as one record (api/scene.py shade_records), the layout the shade
    pass reads."""

    heights: torch.Tensor          # (N, N) f32 height samples
    pyr_flat: torch.Tensor         # (T,) f32 flat level-major max pyramid
    pyr_min_flat: torch.Tensor     # (T - m*m,) f32 flat min pyramid, levels >= 1
    corners: torch.Tensor          # (m, m, 4) f32 per-cell corner records
    albedo: torch.Tensor | None    # (3, N*N) planar f32 texture, or None
    light: Light
    gx: torch.Tensor               # (N, N) f32 d(height)/dx per sample
    gy: torch.Tensor               # (N, N) f32 d(height)/dy per sample
    shade_rec: torch.Tensor        # (N-1, N-1, 8) f32 per-cell corner gradients
    albedo_rec: torch.Tensor | None  # (N-1, N-1, 12) f32 per-cell corner RGB, or None
    n: int
    m: int
    levels: int

    @property
    def n_cells(self) -> int:
        """Side length of the valid (unpadded) cell grid."""
        return self.n - 1

    @property
    def device(self) -> torch.device:
        return self.heights.device


@dataclasses.dataclass(frozen=True)
class Frame:
    """Render output; stays on the scene's device."""

    color: torch.Tensor                # (H, W, 3) f32 in [0,1]
    depth: torch.Tensor | None         # (H, W) f32 hit distance t (inf = sky)
    normal: torch.Tensor | None        # (H, W, 3) f32 world-space normals
    hit: torch.Tensor | None           # (H, W) bool
