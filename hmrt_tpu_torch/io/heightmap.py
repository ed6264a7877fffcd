"""Procedural terrain and height normalisation (numpy only).

A copy of the numpy path of `hmrt_tpu/io/heightmap.py`: the value-noise
fBm below is the executable spec that the JAX package's native evaluator
reproduces bit for bit, so both packages build the very same terrain from
one seed.
"""

from __future__ import annotations

import numpy as np


def normalize_heights(h: np.ndarray, z_scale: float = None) -> np.ndarray:
    """Normalize raw sample values to world z units: by default z spans
    ~12% of the horizontal extent (terrain-like relief)."""
    h = np.asarray(h, np.float32)
    lo, hi = float(h.min()), float(h.max())
    if hi - lo < 1e-12:
        return np.zeros_like(h)
    if z_scale is None:
        z_scale = 0.12 * (max(h.shape) - 1)
    return (h - lo) / (hi - lo) * np.float32(z_scale)


def _value_noise_grid(n: int, cells: int, g: np.ndarray) -> np.ndarray:
    """Bicubic-smoothstep interpolated value noise on an n x n grid, from
    a pre-drawn (cells+1, cells+1) lattice of values."""
    t = np.linspace(0.0, cells, n, endpoint=False, dtype=np.float32)
    i = np.minimum(t.astype(np.int32), cells - 1)
    f = t - i
    s = f * f * (3.0 - 2.0 * f)  # smoothstep
    g00 = g[np.ix_(i, i)]
    g10 = g[np.ix_(i + 1, i)]
    g01 = g[np.ix_(i, i + 1)]
    g11 = g[np.ix_(i + 1, i + 1)]
    sy, sx = s[:, None], s[None, :]
    return (g00 * (1 - sy) * (1 - sx) + g10 * sy * (1 - sx)
            + g01 * (1 - sy) * sx + g11 * sy * sx)


def procedural_terrain(n: int, seed: int = 0, octaves: int = 6,
                       z_scale: float = None, ridged: bool = True) -> np.ndarray:
    """Deterministic fBm terrain, float32 (n, n), world z units."""
    rng = np.random.default_rng(seed)
    acc = np.zeros((n, n), np.float32)
    amp, cells = 1.0, 4  # amps stay python floats, as in the spec
    for _ in range(octaves):
        c = min(cells, n)
        g = rng.standard_normal((c + 1, c + 1)).astype(np.float32)
        layer = _value_noise_grid(n, c, g)
        if ridged:
            layer = 1.0 - np.abs(layer)
        acc += amp * layer
        amp *= 0.55
        cells *= 2
    return normalize_heights(acc, z_scale)
