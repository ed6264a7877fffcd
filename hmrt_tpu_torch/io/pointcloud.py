"""Point cloud -> heightmap gridding (SURVEY.md section 2 note).

A copy of `hmrt_tpu/io/pointcloud.py` (numpy only).

The survey flags a possible LiDAR/point-cloud preprocessing step in the
reference (unverifiable against the empty mount; SURVEY.md C-inventory
footnote) — "if present it's an extra io/ converter, not a renderer
change". This is that converter: scattered (x, y, z) samples are binned
onto a square grid (max or mean per cell, DEM-style), holes are filled by
iterative neighbor averaging, and the result feeds make_scene like any
other heightmap.

Formats: .xyz / .txt / .csv (whitespace- or comma-separated x y z rows)
and .npy arrays of shape (N, 3).
"""

from __future__ import annotations

import numpy as np


def load_points(path: str) -> np.ndarray:
    """Load an (N, 3) float32 point array."""
    if path.endswith(".npy"):
        pts = np.load(path)
    else:
        with open(path) as f:
            txt = f.read().replace(",", " ")
        pts = np.array(txt.split(), dtype=np.float32)
        if pts.size % 3:
            raise ValueError(f"{path}: point count not divisible by 3")
        pts = pts.reshape(-1, 3)
    pts = np.asarray(pts, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"{path}: expected (N, 3) points, got {pts.shape}")
    return pts


def grid_points(points: np.ndarray, n: int, agg: str = "max",
                fill_iters: int = 64) -> np.ndarray:
    """Bin (x, y, z) points onto an (n, n) height grid.

    agg: "max" (DEM-style canopy/top surface) or "mean".
    Empty cells are filled by iterative averaging of filled neighbors
    (then the global mean for anything still empty).
    """
    pts = np.asarray(points, np.float32)
    if len(pts) == 0:
        raise ValueError("no points")
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    x0, x1 = float(x.min()), float(x.max())
    y0, y1 = float(y.min()), float(y.max())
    sx = (n - 1) / max(x1 - x0, 1e-12)
    sy = (n - 1) / max(y1 - y0, 1e-12)
    ix = np.clip(((x - x0) * sx + 0.5).astype(np.int64), 0, n - 1)
    iy = np.clip(((y - y0) * sy + 0.5).astype(np.int64), 0, n - 1)
    flat = iy * n + ix

    if agg == "max":
        h = np.full(n * n, -np.inf, np.float32)
        np.maximum.at(h, flat, z)
        filled = np.isfinite(h)
    elif agg == "mean":
        s = np.zeros(n * n, np.float64)
        c = np.zeros(n * n, np.int64)
        np.add.at(s, flat, z)
        np.add.at(c, flat, 1)
        filled = c > 0
        h = np.where(filled, s / np.maximum(c, 1), 0.0).astype(np.float32)
    else:
        raise ValueError(f"unknown agg {agg!r}")

    h = h.reshape(n, n)
    mask = filled.reshape(n, n)
    h = np.where(mask, h, 0.0).astype(np.float32)

    # hole filling: average of filled 4-neighbors, iterated
    for _ in range(fill_iters):
        if mask.all():
            break
        hp = np.pad(h, 1, mode="edge")
        mp = np.pad(mask, 1, mode="constant")
        nb_sum = (hp[:-2, 1:-1] * mp[:-2, 1:-1] + hp[2:, 1:-1] * mp[2:, 1:-1]
                  + hp[1:-1, :-2] * mp[1:-1, :-2] + hp[1:-1, 2:] * mp[1:-1, 2:])
        nb_cnt = (mp[:-2, 1:-1].astype(np.int32) + mp[2:, 1:-1]
                  + mp[1:-1, :-2] + mp[1:-1, 2:])
        grow = (~mask) & (nb_cnt > 0)
        h = np.where(grow, nb_sum / np.maximum(nb_cnt, 1), h).astype(np.float32)
        mask = mask | grow
    if not mask.all():
        h = np.where(mask, h, h[mask].mean()).astype(np.float32)
    return h


def load_pointcloud_heightmap(path: str, n: int = 1024, agg: str = "max",
                              z_scale: float | None = None) -> np.ndarray:
    """File -> gridded, normalized (n, n) heightmap (world z units)."""
    from hmrt_tpu_torch.io.heightmap import normalize_heights
    h = grid_points(load_points(path), n, agg=agg)
    return normalize_heights(h, z_scale)
