"""The configurations' inputs, made from the configuration alone.

`fbm_terrain` is a frozen copy of the algorithm of the port's
`io/heightmap.py::procedural_terrain` (ridged value-noise fBm: octave
lattices drawn from one numpy generator, smoothstep interpolation, then
heights scaled to span `z_scale_frac` of the map's side), evaluated in
plain torch on the device. It is not bit-equal to the port's terrain and
need not be: the benchmark hands the same array to the port and to the
reference. `height_slope_albedo` is a frozen copy of the rule of the
port's `bench/configs.py::bench_albedo`, also in torch.
"""

from __future__ import annotations

import numpy as np
import torch


def _value_noise(n: int, cells: int, lattice: torch.Tensor) -> torch.Tensor:
    t = torch.arange(n, dtype=torch.float64, device=lattice.device) * (cells / n)
    t = t.to(torch.float32)
    i = torch.clamp(t.to(torch.int64), max=cells - 1)
    f = t - i
    s = f * f * (3.0 - 2.0 * f)
    sy, sx = s[:, None], s[None, :]
    g00 = lattice[i][:, i]
    g10 = lattice[i + 1][:, i]
    g01 = lattice[i][:, i + 1]
    g11 = lattice[i + 1][:, i + 1]
    return g00 * (1 - sy) * (1 - sx) + g10 * sy * (1 - sx) + g01 * (1 - sy) * sx + g11 * sy * sx


def fbm_terrain(n: int, spec: dict, device) -> torch.Tensor:
    """(n, n) float32 heights on `device` from the configuration's
    `terrain` entry: seed, octaves, ridged, z_scale_frac."""
    rng = np.random.default_rng(int(spec["seed"]))
    acc = torch.zeros((n, n), dtype=torch.float32, device=device)
    amp, cells = 1.0, 4
    for _ in range(int(spec["octaves"])):
        c = min(cells, n)
        lattice = torch.from_numpy(rng.standard_normal((c + 1, c + 1)).astype(np.float32))
        layer = _value_noise(n, c, lattice.to(device))
        if spec["ridged"]:
            layer = 1.0 - torch.abs(layer)
        acc += amp * layer
        amp *= 0.55
        cells *= 2
    lo, hi = acc.min(), acc.max()
    return ((acc - lo) / (hi - lo) * float(spec["z_scale_frac"] * (n - 1))).contiguous()


def height_slope_albedo(h: torch.Tensor, spec: dict) -> torch.Tensor:
    """(n, n, 3) float32 albedo: grass blended to rock by slope and to snow
    by height, as the configuration's `albedo` entry gives the colours."""
    gy, gx = torch.gradient(h)
    slope = torch.hypot(gx, gy)
    hnorm = (h - h.min()) / (h.max() - h.min() + 1e-9)
    grass, rock, snow = (torch.tensor(spec[k], dtype=torch.float32, device=h.device)
                         for k in ("grass", "rock", "snow"))
    w_rock = torch.clamp(slope / (slope.mean() * 2 + 1e-9), 0, 1)[..., None]
    w_snow = torch.clamp((hnorm - spec["snow_above"]) * 4, 0, 1)[..., None]
    albedo = grass * (1 - w_rock) + rock * w_rock
    return (albedo * (1 - w_snow) + snow * w_snow).contiguous()


def make_inputs(config: dict, device):
    """(heights, albedo or None) of a configuration, on `device`."""
    h = fbm_terrain(int(config["map_n"]), config["terrain"], device)
    albedo = None if config.get("albedo") is None else height_slope_albedo(h, config["albedo"])
    return h, albedo
