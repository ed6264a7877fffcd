"""Camera paths from a traffic mix's parameters: one general generator.

A traffic file (`traffic/<name>.json`) describes a loop of keyframes around
the map's centre and how the camera looks; `lap_views` turns it into the
eye and target of every frame of one lap, and `seeded_lap` places a run on
that lap: `--seed` picks the entry phase (uniform over the lap) and a
sub-cell translation of the camera, at most `jitter_cells` in x and y. So
two seeds render the same views up to a part of one lap, from rays that
differ.

Keys k = 0..K-1 sit at angle a_k on a circle of radius r_k * n about
((n-1)/2, (n-1)/2), at height zmax + h_k * n, with r_k and h_k linear in k
from the first to the second value of `radius_frac` and
`eye_above_max_frac`:
  - "loop": "closed": a_k = 360 k / K, a Catmull-Rom spline through the keys
    and back to the first;
  - "loop": "replay": a_k = sweep_deg k / (K - 1), the open spline with its
    end keys doubled, as `api/flythrough.py::flythrough` evaluates it; a
    lap ends at the last key and the next starts again at the first.
The camera looks along the path ("look": {"kind": "tangent", "pitch_deg"})
or at a fixed point ("look": {"kind": "target", "target_frac": [fx, fy],
"target_z_of_max": f}, the point (fx (n-1), fy (n-1), f zmax)).

The spline is evaluated in float32, as the port's flythrough does, and
frozen here so that later changes to the port cannot move the yardstick.
"""

from __future__ import annotations

import numpy as np


def catmull_rom(p0, p1, p2, p3, t):
    """A Catmull-Rom segment at t in [0, 1]; arrays broadcast."""
    t2 = t * t
    t3 = t2 * t
    return 0.5 * ((2.0 * p1) + (-p0 + p2) * t
                  + (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3) * t2
                  + (-p0 + 3.0 * p1 - 3.0 * p2 + p3) * t3)


def _keys(traffic: dict, n: int, zmax: float) -> np.ndarray:
    k_n = int(traffic["keys"])
    k = np.arange(k_n, dtype=np.float64)
    if traffic["loop"] == "closed":
        ang = 2.0 * np.pi * k / k_n
    elif traffic["loop"] == "replay":
        ang = np.deg2rad(float(traffic["sweep_deg"])) * k / (k_n - 1)
    else:
        raise ValueError(f"unknown loop {traffic['loop']!r}")
    frac = k / max(k_n - 1, 1)
    r0, r1 = traffic["radius_frac"]
    h0, h1 = traffic["eye_above_max_frac"]
    r = (r0 + (r1 - r0) * frac) * n
    h = zmax + (h0 + (h1 - h0) * frac) * n
    c = (n - 1) / 2.0
    return np.stack([c + r * np.cos(ang), c + r * np.sin(ang), h], -1).astype(np.float32)


def _spline(keys: np.ndarray, closed: bool, frames: int) -> np.ndarray:
    k_n = len(keys)
    if closed:
        pts = np.concatenate([keys[-1:], keys, keys[:2]])
        n_seg = k_n
    else:
        pts = np.concatenate([keys[:1], keys, keys[-1:]])
        n_seg = k_n - 1
    u = np.linspace(0.0, n_seg, frames, endpoint=False, dtype=np.float32)
    seg = np.minimum(u.astype(np.int32), n_seg - 1)
    t = (u - seg).astype(np.float32)[:, None]
    return np.ascontiguousarray(catmull_rom(pts[seg], pts[seg + 1], pts[seg + 2],
                                            pts[seg + 3], t), np.float32)


def lap_views(traffic: dict, n: int, zmax: float):
    """(eyes, targets), each float64 (F, 3): every frame of one lap."""
    frames = int(traffic["frames_per_lap"])
    closed = traffic["loop"] == "closed"
    eyes = _spline(_keys(traffic, n, zmax), closed, frames).astype(np.float64)
    look = traffic["look"]
    if look["kind"] == "target":
        fx, fy = look["target_frac"]
        tgt = np.array([fx * (n - 1), fy * (n - 1), look["target_z_of_max"] * zmax])
        targets = np.broadcast_to(tgt, eyes.shape).copy()
    elif look["kind"] == "tangent":
        nxt = np.roll(eyes, -1, 0)
        prv = np.roll(eyes, 1, 0)
        if not closed:
            nxt[-1], prv[0] = eyes[-1], eyes[0]
        fwd = (nxt - prv)[:, :2]
        fwd /= np.linalg.norm(fwd, axis=1, keepdims=True)
        pitch = np.deg2rad(float(look["pitch_deg"]))
        d = np.concatenate([fwd * np.cos(pitch), np.full((frames, 1), -np.sin(pitch))], 1)
        targets = eyes + d * (0.25 * n)
    else:
        raise ValueError(f"unknown look {look['kind']!r}")
    return eyes, targets


def seeded_lap(traffic: dict, n: int, zmax: float, seed: int):
    """This run's lap: (eyes, targets) in the order the run renders them,
    starting at a phase drawn from `seed`, every camera translated by one
    jitter in x and y drawn from `seed`; and the lap views (indices into
    that order) whose last frame in the window the output check compares:
    `check_frames` of the first `check_span`, drawn from `seed`, so that a
    window of `check_span` frames renders each."""
    rng = np.random.default_rng(seed)
    eyes, targets = lap_views(traffic, n, zmax)
    frames = len(eyes)
    start = int(rng.integers(frames))
    j = float(traffic["jitter_cells"])
    shift = np.array([*rng.uniform(-j, j, 2), 0.0])
    order = (start + np.arange(frames)) % frames
    span = min(int(traffic["check_span"]), frames)
    checked = np.sort(rng.choice(span, int(traffic["check_frames"]), replace=False))
    return eyes[order] + shift, targets[order] + shift, [int(i) for i in checked]
