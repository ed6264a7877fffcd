"""Scripted camera flythrough: a batched Camera along a keyframe spline.

Counterpart of `hmrt_tpu/api/flythrough.py`. The spline is evaluated in
numpy float32, exactly as the JAX package does it, so both packages give
the same eye and target bits. The result is one `Camera` whose fields
carry a leading (F,) frame axis; `frame_camera` picks one frame out of it
for `render_frame`, which a host loop calls once per frame.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hmrt_tpu_torch.device import resolve
from hmrt_tpu_torch.types import Camera


def catmull_rom(p0, p1, p2, p3, t):
    """Catmull-Rom spline segment, t in [0,1]; arrays broadcast."""
    t2 = t * t
    t3 = t2 * t
    return 0.5 * ((2.0 * p1)
                  + (-p0 + p2) * t
                  + (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3) * t2
                  + (-p0 + 3.0 * p1 - 3.0 * p2 + p3) * t3)


def flythrough(keyframes, n_frames: int, fov_y_deg: float = 55.0,
               device=None) -> Camera:
    """Batched Camera along a Catmull-Rom path through keyframes, on
    `device` (default: the CUDA card).

    keyframes: sequence of (eye_xyz, target_xyz) pairs (>= 2). The
    Camera's eye and target are (n_frames, 3), up (n_frames, 3) and fov_y
    (n_frames,); index it with `frame_camera`."""
    device = resolve(device)
    eyes = np.asarray([k[0] for k in keyframes], np.float32)
    tgts = np.asarray([k[1] for k in keyframes], np.float32)
    if len(eyes) < 2:
        raise ValueError("need at least 2 keyframes")
    # pad endpoints for Catmull-Rom
    eyes_p = np.concatenate([eyes[:1], eyes, eyes[-1:]])
    tgts_p = np.concatenate([tgts[:1], tgts, tgts[-1:]])
    n_seg = len(eyes) - 1
    u = np.linspace(0.0, n_seg, n_frames, endpoint=False, dtype=np.float32)
    seg = np.minimum(u.astype(np.int32), n_seg - 1)
    t = (u - seg).astype(np.float32)[:, None]

    def interp(pts):
        return torch.from_numpy(np.ascontiguousarray(catmull_rom(
            pts[seg], pts[seg + 1], pts[seg + 2], pts[seg + 3], t), np.float32)).to(device)

    up = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=device)
    fov = torch.deg2rad(torch.tensor(fov_y_deg, dtype=torch.float32, device=device))
    return Camera(eye=interp(eyes_p), target=interp(tgts_p),
                  up=up.expand(n_frames, 3).contiguous(),
                  fov_y=fov.expand(n_frames).contiguous())


def frame_camera(cams: Camera, i: int) -> Camera:
    """Frame i of a batched Camera: each field indexed on its frame axis."""
    return Camera(**{f.name: getattr(cams, f.name)[i] for f in dataclasses.fields(cams)})


def orbit_flythrough(n: int, zmax: float, n_frames: int,
                     height_frac: float = 0.10, device=None) -> Camera:
    """Default benchmark path: a descending orbit over an n x n map."""
    c = (n - 1) / 2.0
    keys = []
    for k in range(9):
        ang = 2.0 * np.pi * k / 8.0
        r = 0.42 * n * (1.0 - 0.05 * k / 8.0)
        h = zmax + height_frac * n * (1.0 - 0.5 * k / 8.0)
        keys.append(((c + r * np.cos(ang), c + r * np.sin(ang), h),
                     (c, c, zmax * 0.4)))
    return flythrough(keys, n_frames, device=device)
