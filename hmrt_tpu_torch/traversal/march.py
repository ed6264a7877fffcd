"""Max-mipmap / DDA heightfield ray march as a masked wavefront.

Counterpart of `hmrt_tpu/traversal/march.py`. All rays step in lockstep;
per-lane state is {t, level, cell, alive} plus the hit results, and every
branch is a `torch.where` select. One step of the max-mip march is
`maxmip_step`; the oracle's `march_maxmip` and the plain version of the
march kernel (`kernels/march_pass.py::march_pass_reference`) both run it,
and the CUDA kernel repeats it line for line.

Robustness rules, as in the JAX package: cell coordinates are INTEGER
per-lane state, so every step makes integer progress and no epsilon is
ever added to t; level changes are exact integer ops (ascend = cell >> k,
descend = 2*cell + side of the child midpoint); boundary t values are
computed from the ray ORIGIN, never accumulated. A float is clamped to the
target range before it is converted to an integer: that equals the JAX
convert-then-clip for every in-range value, and stays defined where the
conversion would overflow.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hmrt_tpu_torch.core.pyramid import flat_index
from hmrt_tpu_torch.traversal.intersect import BIG_T, INTERSECTORS

EPS_EXIT = 1.0e-6
T_TOL = 1.0e-3   # slack on [t_lo, t_hi] for the exact intersection test

#: masked steps between two checks of "any lane alive" (each check waits
#: for the device); extra steps on dead lanes change nothing
CHECK_EVERY = 8


class MarchResult(NamedTuple):
    hit: torch.Tensor  # bool[P]
    t: torch.Tensor    # f32[P] hit distance (BIG_T if miss)
    cx: torch.Tensor   # i32[P] hit cell x (level 0)
    cy: torch.Tensor   # i32[P] hit cell y


def ray_inverses(dx, dy):
    """Safe reciprocal direction components."""
    inv_x = 1.0 / torch.where(torch.abs(dx) < 1e-20, 1e-20, dx)
    inv_y = 1.0 / torch.where(torch.abs(dy) < 1e-20, 1e-20, dy)
    return inv_x, inv_y


def ray_box_range(ox, oy, dx, dy, world_max, clip=None):
    """Clip rays to the terrain slab x,y in [0, world_max] (or to the cell
    window `clip=(lo, hi)`); returns (t0, t1, valid)."""
    lo, hi = (0.0, world_max) if clip is None else clip
    inv_x, inv_y = ray_inverses(dx, dy)
    tx0 = (lo - ox) * inv_x
    tx1 = (hi - ox) * inv_x
    ty0 = (lo - oy) * inv_y
    ty1 = (hi - oy) * inv_y
    t_lo = torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1))
    t_hi = torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1))
    t0 = torch.clamp_min(t_lo, 0.0)
    return t0, t_hi, t_hi > t0


def _cell_side(lvl):
    """2^lvl as f32 (exact) from an int or an integer tensor level."""
    if isinstance(lvl, int):
        return float(1 << lvl)
    return (1 << lvl).to(torch.float32)


def entry_cell(ox, oy, dx, dy, t0, lvl, side: int):
    """Integer cell containing the entry point at level `lvl` (clamped to
    [0, side-1])."""
    s = _cell_side(lvl)
    px = ox + t0 * dx
    py = oy + t0 * dy
    icx = torch.clamp(torch.floor(px / s), 0.0, float(side - 1)).to(torch.int32)
    icy = torch.clamp(torch.floor(py / s), 0.0, float(side - 1)).to(torch.int32)
    return icx, icy


def step_geometry(ox, oy, dx, dy, icx, icy, lvl, inv_x, inv_y):
    """Exit t of integer cell (icx, icy) at level `lvl`, the stepped
    neighbour cell, and the crossed boundary index (ascent test input)."""
    s = _cell_side(lvl)
    pos_x = dx > 0.0
    pos_y = dy > 0.0
    bx = icx + pos_x.to(torch.int32)
    by = icy + pos_y.to(torch.int32)
    tx = (bx.to(torch.float32) * s - ox) * inv_x
    ty = (by.to(torch.float32) * s - oy) * inv_y
    tx = torch.where(torch.abs(dx) < 1e-20, BIG_T, tx)
    ty = torch.where(torch.abs(dy) < 1e-20, BIG_T, ty)
    axis_x = tx <= ty                            # tie -> step x first
    t_exit = torch.minimum(tx, ty)
    nx = torch.where(axis_x, icx + (pos_x.to(torch.int32) * 2 - 1), icx)
    ny = torch.where(axis_x, icy, icy + (pos_y.to(torch.int32) * 2 - 1))
    return t_exit, nx, ny, torch.where(axis_x, bx, by)


def ascent_levels(b):
    """Levels to ascend after crossing boundary index b: trailing zero
    bits of b, capped at 3."""
    return (((b & 1) == 0).to(torch.int32) + ((b & 3) == 0).to(torch.int32)
            + ((b & 7) == 0).to(torch.int32))


def descend_cell(ox, oy, dx, dy, t, icx, icy, lvl):
    """Child cell (at lvl-1) containing the position at parameter t.
    Callers mask out lvl == 0 lanes; the clamp keeps the shift defined."""
    s_child = _cell_side(torch.clamp_min(lvl - 1, 0))
    px = ox + t * dx
    py = oy + t * dy
    cx2 = 2 * icx
    cy2 = 2 * icy
    right = px >= (cx2 + 1).to(torch.float32) * s_child
    up = py >= (cy2 + 1).to(torch.float32) * s_child
    return cx2 + right.to(torch.int32), cy2 + up.to(torch.int32)


def corner_heights(heights_flat, n: int, cx, cy):
    """The 4 corner heights of fine cell (cx, cy), cells clamped to
    [0, n-2] first so masked lanes in padded cells stay in bounds."""
    cx = torch.clamp(cx, 0, n - 2)
    cy = torch.clamp(cy, 0, n - 2)
    base = cy * n + cx
    return (heights_flat.index_select(0, base),
            heights_flat.index_select(0, base + 1),
            heights_flat.index_select(0, base + n),
            heights_flat.index_select(0, base + n + 1))


class WorkCounter:
    """What a masked max-mip march does, counted on its device without a
    wait: the steps taken (one per alive lane per step), the exact cell
    tests, and which pyramid entries and height samples it reads. A
    kernel's bound in bytes and operations is computed from these. With
    `lanes`, it also keeps each lane's steps and tests (`lane_steps`,
    `lane_tests`, int32[lanes]): what the kernels' counting instances
    write per ray."""

    def __init__(self, pyr_size: int, n: int, device, lanes: int | None = None):
        self.n = n
        self.steps = torch.zeros((), dtype=torch.int64, device=device)
        self.tests = torch.zeros((), dtype=torch.int64, device=device)
        self.pyr_reads = torch.zeros(pyr_size, dtype=torch.int32, device=device)
        self.height_reads = torch.zeros(n * n, dtype=torch.int32, device=device)
        self.lane_steps = self.lane_tests = None
        if lanes is not None:
            self.lane_steps = torch.zeros(lanes, dtype=torch.int32, device=device)
            self.lane_tests = torch.zeros(lanes, dtype=torch.int32, device=device)

    def observe(self, alive, idx, test, icx, icy):
        """One step: every alive lane reads pyramid entry `idx`; the lanes
        in `test` also read the 4 corner heights of cell (icx, icy)."""
        n = self.n
        self.steps += alive.sum()
        self.tests += test.sum()
        if self.lane_steps is not None:
            self.lane_steps += alive.to(torch.int32)
            self.lane_tests += test.to(torch.int32)
        self.pyr_reads.index_add_(0, idx, alive.to(torch.int32))
        base = torch.clamp(icy, 0, n - 2) * n + torch.clamp(icx, 0, n - 2)
        for off in (0, 1, n, n + 1):
            self.height_reads.index_add_(0, base + off, test.to(torch.int32))

    def unique_bytes(self) -> int:
        """Bytes of the distinct f32 pyramid entries and heights read."""
        return 4 * int((self.pyr_reads > 0).sum() + (self.height_reads > 0).sum())


def maxmip_step(ray, st, pyr_flat, heights_flat, gmax, *, n: int, m: int,
                levels: int, intersector, counter: WorkCounter | None = None):
    """One masked max-mip step for the alive lanes of `st`.

    ray = (ox, oy, oz, dx, dy, dz, inv_x, inv_y, t1); st holds t, lvl,
    icx, icy, alive (bool), hit (bool), t_hit, hx, hy. A lane that is not
    alive is left exactly as it was. `counter` records the step's work."""
    ox, oy, oz, dx, dy, dz, inv_x, inv_y, t1 = ray
    t, lvl, alive = st["t"], st["lvl"], st["alive"]
    icx, icy = st["icx"], st["icy"]

    t_exit, nx, ny, bnd = step_geometry(ox, oy, dx, dy, icx, icy, lvl,
                                        inv_x, inv_y)
    t_exit_c = torch.minimum(t_exit, t1)
    # min ray height over [t, t_exit_c] (z is linear in t)
    zmin = oz + torch.minimum(t * dz, t_exit_c * dz)

    side_m1 = (m >> lvl) - 1
    idx = flat_index(m, lvl,
                     torch.minimum(torch.clamp_min(icy, 0), side_m1),
                     torch.minimum(torch.clamp_min(icx, 0), side_m1))
    cmax = pyr_flat.index_select(0, idx)

    skip = zmin > cmax
    at_fine = lvl == 0
    descend = ~skip & ~at_fine
    test = ~skip & at_fine & alive
    if counter is not None:
        counter.observe(alive, idx, test, icx, icy)

    z00, z10, z01, z11 = corner_heights(heights_flat, n, icx, icy)
    hit_now, t_c = intersector(ox, oy, oz, dx, dy, dz, icx, icy,
                               z00, z10, z01, z11,
                               t - T_TOL, t_exit_c + T_TOL)
    hit_now = hit_now & test
    advance = alive & ~descend & ~hit_now

    dcx, dcy = descend_cell(ox, oy, dx, dy, t, icx, icy, lvl)
    # multi-level ascent on a skip-advance; a failed exact test does not
    # ascend (terrain-hugging rays would ping-pong descend/ascend)
    asc = torch.where(alive & skip & advance, ascent_levels(bnd), 0)
    asc = torch.minimum(asc, (levels - 1) - lvl)
    new_lvl = torch.where(descend, lvl - 1, lvl + asc)
    new_icx = torch.where(descend, dcx, torch.where(advance, nx >> asc, icx))
    new_icy = torch.where(descend, dcy, torch.where(advance, ny >> asc, icy))
    new_t = torch.where(advance, torch.maximum(t, t_exit_c), t)

    new_side = m >> new_lvl
    # exact escape test: above the global max and climbing => miss
    escaped = advance & (oz + new_t * dz > gmax) & (dz > 0.0)
    out = (advance & ((t_exit >= t1 - EPS_EXIT)
                      | (new_icx < 0) | (new_icx >= new_side)
                      | (new_icy < 0) | (new_icy >= new_side))
           | escaped)
    return dict(
        t=new_t,
        lvl=torch.where(alive, new_lvl, lvl),
        icx=torch.where(alive, new_icx, icx),
        icy=torch.where(alive, new_icy, icy),
        alive=alive & ~hit_now & ~out,
        hit=st["hit"] | hit_now,
        t_hit=torch.where(hit_now, t_c, st["t_hit"]),
        hx=torch.where(hit_now, icx, st["hx"]),
        hy=torch.where(hit_now, icy, st["hy"]),
    )


def run_masked(step, st, max_steps: int):
    """Apply `step` to `st` until no lane is alive or `max_steps` steps
    have run. Every lane is stepped exactly min(max_steps, its own steps
    to termination) times."""
    i = 0
    while i < max_steps and bool(st["alive"].any()):
        k = min(CHECK_EVERY, max_steps - i)
        for _ in range(k):
            st = step(st)
        i += k
    return st


def _results(p, device):
    return dict(hit=torch.zeros(p, dtype=torch.bool, device=device),
                t_hit=torch.full((p,), BIG_T, dtype=torch.float32, device=device),
                hx=torch.zeros(p, dtype=torch.int32, device=device),
                hy=torch.zeros(p, dtype=torch.int32, device=device))


def march_maxmip(ox, oy, oz, dx, dy, dz, pyr_flat, heights_flat, *,
                 n: int, m: int, levels: int, max_steps: int,
                 cell_intersect: str = "triangle",
                 start_level: int | None = None,
                 clip: tuple | None = None) -> MarchResult:
    """Masked-wavefront maximum-mipmap march over a batch of f32[P] rays,
    descending from level `start_level` (default: the pyramid top). The
    shadow march is the same traversal; its caller reads only `hit`."""
    top = levels - 1 if start_level is None else min(start_level, levels - 1)
    t0, t1, valid = ray_box_range(ox, oy, dx, dy, float(n - 1), clip)
    inv_x, inv_y = ray_inverses(dx, dy)
    gmax = pyr_flat[-1]
    # early-out sky test: starts above the global max and never descends
    valid = valid & ~((oz + t0 * dz > gmax) & (dz >= 0.0))
    icx, icy = entry_cell(ox, oy, dx, dy, t0, top, m >> top)
    st = dict(t=torch.where(valid, t0, BIG_T),
              lvl=torch.full_like(icx, top), icx=icx, icy=icy, alive=valid,
              **_results(ox.shape[0], ox.device))
    ray = (ox, oy, oz, dx, dy, dz, inv_x, inv_y, t1)
    intersector = INTERSECTORS[cell_intersect]
    st = run_masked(lambda s: maxmip_step(ray, s, pyr_flat, heights_flat, gmax,
                                          n=n, m=m, levels=levels,
                                          intersector=intersector),
                    st, max_steps)
    return MarchResult(st["hit"], st["t_hit"], st["hx"], st["hy"])


def march_dda(ox, oy, oz, dx, dy, dz, heights_flat, *, n: int,
              max_steps: int, cell_intersect: str = "triangle",
              clip: tuple | None = None) -> MarchResult:
    """Brute-force uniform-grid DDA at the finest level: tests every
    crossed cell with the exact intersector, independent of the pyramid
    (B1's traversal, and the oracle of the max-mip march's exactness)."""
    intersector = INTERSECTORS[cell_intersect]
    n_cells = n - 1
    t0, t1, valid = ray_box_range(ox, oy, dx, dy, float(n - 1), clip)
    inv_x, inv_y = ray_inverses(dx, dy)
    icx, icy = entry_cell(ox, oy, dx, dy, t0, 0, n_cells)

    def step(st):
        t, alive, icx, icy = st["t"], st["alive"], st["icx"], st["icy"]
        t_exit, nx, ny, _ = step_geometry(ox, oy, dx, dy, icx, icy, 0,
                                          inv_x, inv_y)
        t_exit_c = torch.minimum(t_exit, t1)
        z00, z10, z01, z11 = corner_heights(heights_flat, n, icx, icy)
        hit_now, t_c = intersector(ox, oy, oz, dx, dy, dz, icx, icy,
                                   z00, z10, z01, z11,
                                   t - T_TOL, t_exit_c + T_TOL)
        hit_now = hit_now & alive
        out = ((t_exit >= t1 - EPS_EXIT) | (nx < 0) | (nx >= n_cells)
               | (ny < 0) | (ny >= n_cells))
        return dict(t=torch.where(alive, torch.maximum(t, t_exit_c), t),
                    icx=torch.where(alive, nx, icx),
                    icy=torch.where(alive, ny, icy),
                    alive=alive & ~hit_now & ~out,
                    hit=st["hit"] | hit_now,
                    t_hit=torch.where(hit_now, t_c, st["t_hit"]),
                    hx=torch.where(hit_now, icx, st["hx"]),
                    hy=torch.where(hit_now, icy, st["hy"]))

    st = dict(t=torch.where(valid, t0, BIG_T), icx=icx, icy=icy, alive=valid,
              **_results(ox.shape[0], ox.device))
    st = run_masked(step, st, max_steps)
    return MarchResult(st["hit"], st["t_hit"], st["hx"], st["hy"])
