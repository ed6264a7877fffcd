"""Max-mipmap / DDA heightfield ray march as a masked wavefront.

Counterpart of `hmrt_tpu/traversal/march.py`. All rays step in lockstep;
per-lane state is {t, level, cell, alive} plus the hit results, and every
branch is a `torch.where` select. One step of the max-mip march is
`maxmip_step`; the oracle's `march_maxmip` and the plain version of the
march kernel (`kernels/march_pass.py::march_pass_reference`) both run it,
and the CUDA kernel repeats it line for line. The level-0 tail of the
compact path has two more steps, `l0_step` (exact, every cell) and
`l0_step_relaxed` (stride sampling with an exact walk over each bracket),
the counterparts of `hmrt_tpu/kernels/march_body.py::wavefront_step_l0`
and `wavefront_step_l0_relaxed`. `l0_min_step` is the exact tail as the
CUDA kernel marches it: `l0_step`'s walk and hits, but a ray that stays
under a block's lowest corner passes the whole block untested, and one
under the map's lowest height ends.

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

from hmrt_tpu_torch.core.pyramid import NEG_INF, flat_index, min_flat_size
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
        in `test` also read the 4 corner heights of cell (icx, icy). With
        (lanes, G) planes, a window of G steps of each lane (l0_group_march)."""
        n = self.n
        self.steps += alive.sum()
        self.tests += test.sum()
        if self.lane_steps is not None:
            dim = alive.dim() - 1
            self.lane_steps += alive.sum(dim, dtype=torch.int32) if dim else alive.to(torch.int32)
            self.lane_tests += test.sum(dim, dtype=torch.int32) if dim else test.to(torch.int32)
        alive, idx, test, icx, icy = (x.reshape(-1) for x in (alive, idx, test, icx, icy))
        self.pyr_reads.index_add_(0, idx, alive.to(torch.int32))
        base = torch.clamp(icy, 0, n - 2) * n + torch.clamp(icx, 0, n - 2)
        for off in (0, 1, n, n + 1):
            self.height_reads.index_add_(0, base + off, test.to(torch.int32))

    def unique_bytes(self) -> int:
        """Bytes of the distinct f32 pyramid entries and heights read."""
        return 4 * int((self.pyr_reads > 0).sum() + (self.height_reads > 0).sum())


def maxmip_step(ray, st, pyr_flat, heights_flat, gmax, *, n: int, m: int,
                levels: int, intersector, counter: WorkCounter | None = None,
                cone=None):
    """One masked max-mip step for the alive lanes of `st`.

    ray = (ox, oy, oz, dx, dy, dz, inv_x, inv_y, t1); st holds t, lvl,
    icx, icy, alive (bool), hit (bool), t_hit, hx, hy. A lane that is not
    alive is left exactly as it was. `counter` records the step's work.
    `cone=(cone_flat, cone_radius)`: the cone field of core/cone.py; a
    level-0 lane whose exact test missed then advances by its safe jump of
    several cells where the cone allows one (hits unchanged)."""
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

    jump = None
    if cone is not None:
        # the cone jump (core/cone.py): a level-0 lane whose cell-max skip
        # and exact test both failed (the grazing regime) may advance
        # several cells when the cone over its apex sample clears the ray
        from hmrt_tpu_torch.core.cone import cone_safe_cells
        cone_flat, cone_radius = cone
        inv_vmax = 1.0 / torch.clamp_min(torch.maximum(torch.abs(dx), torch.abs(dy)), 1e-20)
        capex = cone_flat.index_select(
            0, torch.clamp(icy, 0, n - 2) * n + torch.clamp(icx, 0, n - 2))
        kj = cone_safe_cells(oz + t_exit_c * dz, z00, capex, dz * inv_vmax, cone_radius)
        jump = advance & at_fine & ~skip & (kj >= 2)
        t_j = t_exit_c + kj.to(torch.float32) * inv_vmax
        new_t = torch.where(jump, t_j, new_t)
        new_icx = torch.where(jump, floor_cell(ox + t_j * dx, m), new_icx)
        new_icy = torch.where(jump, floor_cell(oy + t_j * dy, m), new_icy)
        new_lvl = torch.where(jump, 0, new_lvl)

    new_side = m >> new_lvl
    # exact escape test: above the global max and climbing => miss
    escaped = advance & (oz + new_t * dz > gmax) & (dz > 0.0)
    ends = ((t_exit >= t1 - EPS_EXIT) | (new_icx < 0) | (new_icx >= new_side)
            | (new_icy < 0) | (new_icy >= new_side))
    if jump is None:
        out = (advance & ends) | escaped
    else:
        out = (advance & ~jump & ends) | (jump & (t_j >= t1 - EPS_EXIT)) | escaped
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


def floor_cell(x, m: int):
    """Integer cell of coordinate x, floor(x) clamped to [0, m-1]."""
    return torch.clamp(torch.floor(x), 0.0, float(m - 1)).to(torch.int32)


def record_corners(heights_flat, n: int, m: int):
    """corners(cx, cy) -> the four corner heights of level-0 cell (cx, cy)
    as the kernels read them from its corner record (core/pyramid.py
    corner_records): the cell clamped into [0, m-1], NEG_INF in all four on
    a padded cell (cx or cy >= n-1), so a padded cell is never hit."""
    def corners(cx, cy):
        pad = (torch.clamp(cx, 0, m - 1) >= n - 1) | (torch.clamp(cy, 0, m - 1) >= n - 1)
        return tuple(torch.where(pad, NEG_INF, z)
                     for z in corner_heights(heights_flat, n, cx, cy))
    return corners


def _cell_index0(m: int, icx, icy):
    """Flat pyramid index of level-0 cell (icx, icy), clamped into the grid:
    the entry a level-0 step reads (the max of the cell's record)."""
    return torch.clamp(icy, 0, m - 1) * m + torch.clamp(icx, 0, m - 1)


def l0_step(ray, st, corners, gmax, *, m: int, intersector,
            counter: WorkCounter | None = None):
    """One masked step of the forced-level-0 tail: the level-0 DDA with the
    exact test in every cell whose max the ray does not clear, no pyramid
    and no ascent (`hmrt_tpu/kernels/march_body.py::wavefront_step_l0`).
    Every lane is taken as a level-0 lane; `lvl` is not read. The skip
    test, the test window and the intersector are those of `maxmip_step`
    at level 0, so the hits are the max-mip march's.

    ray and st as in `maxmip_step`; `corners(icx, icy)` gives a cell's four
    corner heights (`record_corners`)."""
    ox, oy, oz, dx, dy, dz, inv_x, inv_y, t1 = ray
    t, icx, icy, act = st["t"], st["icx"], st["icy"], st["alive"]
    t_exit, nx, ny, _ = step_geometry(ox, oy, dx, dy, icx, icy, 0, inv_x, inv_y)
    t_exit_c = torch.minimum(t_exit, t1)
    zmin = oz + torch.minimum(t * dz, t_exit_c * dz)

    z00, z10, z01, z11 = corners(icx, icy)
    cmax0 = torch.maximum(torch.maximum(z00, z10), torch.maximum(z01, z11))
    h, t_c = intersector(ox, oy, oz, dx, dy, dz, icx, icy, z00, z10, z01, z11,
                         t - T_TOL, t_exit_c + T_TOL)
    skip = zmin > cmax0
    if counter is not None:
        counter.observe(act, _cell_index0(m, icx, icy), act & ~skip, icx, icy)
    hit_now = h & act & ~skip
    advance = act & ~hit_now

    new_t = torch.maximum(t, t_exit_c)
    escaped = advance & (oz + new_t * dz > gmax) & (dz > 0.0)
    out = (advance & ((t_exit >= t1 - EPS_EXIT)
                      | (nx < 0) | (nx >= m) | (ny < 0) | (ny >= m))
           | escaped)
    return dict(st,
                t=torch.where(advance, new_t, t),
                icx=torch.where(advance, nx, icx),
                icy=torch.where(advance, ny, icy),
                alive=act & ~hit_now & ~out,
                hit=st["hit"] | hit_now,
                t_hit=torch.where(hit_now, t_c, st["t_hit"]),
                hx=torch.where(hit_now, icx, st["hx"]),
                hy=torch.where(hit_now, icy, st["hy"]))


#: The margin by which a ray must stay under a cell's (or a block's)
#: lowest corner for the tail to skip its exact test (`below_margins`).
#: u = 2^-24 is the f32 unit roundoff; every term carries at least twice
#: the first-order error bound it stands for (PERF.md, "the margin").
MARGIN_TOL = 1.0e-3 * (1.0 + 2.0 ** -10)  # the test window's slack T_TOL, a unit of |dz|
MARGIN_Z = 2.0 ** -19     # 32 u: rounding at the magnitude Z of the heights along the ray
MARGIN_S = 8.0e-6         # the intersectors' containment slack 1e-6, a unit of corner span
MARGIN_A = 2.0 ** -19     # 32 u: rounding at the ray's world magnitude A, a unit of span
MARGIN_SAFE = 4.0e-20     # the intersectors' divisor floor 1e-20 (`safe`), per unit of t
MARGIN_LIN = 2.0e-12      # bilinear: the quadratic term its linear branch drops, per t^2
MARGIN_A2 = 2.0 ** -19    # bilinear: cancellation in the patch's far-origin coefficients


def below_margins(ray, gmin, gmax, *, m: int, cell_intersect: str):
    """The per-ray constants of the level-0 tail's tests under the terrain,
    (m0, m1, zfloor), f32[P] each, or None for "flat" (its column is hit by
    any ray under it, so it keeps every test).

    A ray that over a cell's test window [t, t_exit] stays below the cell's
    lowest corner by m0 + span * m1 (span: the cell's corner max - min, or
    a block's, which bounds every cell in it) cannot be hit by the exact
    test there: the triangle's planes and the bilinear patch lie between
    the corners, widened by the containment slack (1e-6 of a cell) and by
    the f32 rounding of the test's own expressions. m0 covers the window's
    T_TOL of t, the rounding at the heights' magnitude
    Z = |oz| + max(|gmin|, |gmax|) + |t1| |dz|, and the divisor the
    intersectors raise to 1e-20 when it is smaller (a ray with no slope
    against a cell's plane "meets" it at t ~ its height gap / 1e-20, so
    this term is |t1| 4e-20: it matters only for rays of a near-zero
    direction, whose t1 is huge); m1 the slack and the
    rounding at the ray's world magnitude
    A = |ox| + |oy| + |t1| (|dx| + |dy|) + 2m + 2, times the cell's
    gradients; the bilinear root solve adds A^2 (its coefficients are
    taken about the cell's corner, far from the origin) and |t1|^2 (its
    linear branch). A descending ray under zfloor, the map's lowest height
    less the margin at the whole map's span, is under every cell it has
    left to cross: it ends as a miss. The CUDA kernel computes each in
    this float order (march_common.cuh below_margins)."""
    if cell_intersect == "flat":
        return None
    ox, oy, oz, dx, dy, dz, _, _, t1 = ray
    at1 = torch.abs(t1)
    a = (torch.abs(ox) + torch.abs(oy)) + at1 * (torch.abs(dx) + torch.abs(dy)) + float(2 * m + 2)
    z = (torch.abs(oz) + torch.maximum(torch.abs(gmin), torch.abs(gmax))) + at1 * torch.abs(dz)
    m0 = MARGIN_TOL * torch.abs(dz) + MARGIN_Z * z + MARGIN_SAFE * at1
    m1 = MARGIN_S + MARGIN_A * a
    if cell_intersect == "bilinear":
        m0 = m0 + MARGIN_LIN * (at1 * at1)
        m1 = m1 + MARGIN_A2 * (a * a)
    zfloor = torch.where(dz < 0.0, gmin - (m0 + (gmax - gmin) * m1), -BIG_T)
    return m0, m1, zfloor


def _dda_steps(b0, step, o, inv, none, t_cross, strict: bool, top, rounds: int):
    """How many boundaries of one axis the level-0 DDA crosses before
    t_cross, counting from boundary index b0 (step +-1): the smallest k in
    [0, top] whose exit (`_axis_exit`) is not before t_cross, where
    "before" is < for the y axis against an x crossing and <= for the x
    axis against a y crossing (a tie steps x first, as `step_geometry`).
    The exits never decrease along the axis, so a binary search of
    `rounds` halvings finds it; any search gives the same k."""
    lo = torch.zeros_like(top)
    hi = top
    for _ in range(rounds):
        go = lo < hi
        mid = (lo + hi) >> 1
        e = _axis_exit(b0, mid, step, o, inv, none)
        passed = e < t_cross if strict else e <= t_cross
        lo = torch.where(go & passed, mid + 1, lo)
        hi = torch.where(go & ~passed, mid, hi)
    return lo


def block_crossing(ray, icx, icy, lvl, t_exit, nx, ny, *, levels: int):
    """The level-0 cell the DDA from level-0 cell (icx, icy) enters when it
    leaves that cell's level-`lvl` block, whose exit is t_exit toward block
    (nx, ny) (`step_geometry` at `lvl`): on the crossed axis the first cell
    past the block; on the other the cell where the steps the DDA takes
    inside the block before the crossing put it (`_dda_steps`). At level 0
    it is (nx, ny). The bits of every later exit follow, because exits are
    taken from the origin at integer boundaries."""
    ox, oy, _, dx, dy, _, inv_x, inv_y, _ = ray
    side = 1 << lvl
    pos_x, pos_y = dx > 0.0, dy > 0.0
    sx = torch.where(pos_x, 1, -1).to(torch.int32)
    sy = torch.where(pos_y, 1, -1).to(torch.int32)
    bx, by = icx >> lvl, icy >> lvl
    axis_x = nx != bx
    # on the crossed axis: the first cell past the block
    cx_x = nx * side + torch.where(pos_x, 0, side - 1)
    cy_y = ny * side + torch.where(pos_y, 0, side - 1)
    # on the other: the cells left in the block ahead of the current one bound the steps
    top_y = torch.where(pos_y, by * side + (side - 1) - icy, icy - by * side)
    top_x = torch.where(pos_x, bx * side + (side - 1) - icx, icx - bx * side)
    ky = _dda_steps(icy + pos_y.to(torch.int32), sy, oy, inv_y, torch.abs(dy) < 1e-20, t_exit,
                    True, torch.where(axis_x, top_y, 0), levels)
    kx = _dda_steps(icx + pos_x.to(torch.int32), sx, ox, inv_x, torch.abs(dx) < 1e-20, t_exit,
                    False, torch.where(axis_x, 0, top_x), levels)
    return (torch.where(axis_x, cx_x, icx + kx * sx),
            torch.where(axis_x, icy + ky * sy, cy_y))


def l0_min_step(ray, st, corners, pyr_flat, pyr_min, gmax, below, *, m: int, levels: int,
                intersector, counter: WorkCounter | None = None, hierarchy: bool = True):
    """One masked step of the forced-level-0 tail as the CUDA kernel
    marches it (`march_common.cuh::l0_min_steps`): the walk of `l0_step`,
    with the same hits (hit, t_hit, hx, hy, bit for bit), and two ways to
    end a ray's work early under the terrain (`below_margins`).

    icx, icy are always the level-0 cell `l0_step` would stand in; lvl is
    the level of the block around it that this step takes (0: the cell).
    At level 0 the step is `l0_step`'s: the cell's exit, the skip over a
    cell whose max the ray clears, the exact test in the same window,
    unless the ray stays under the cell's lowest corner by the margin. At a
    level k >= 1 the block's min and max are read from the pyramids
    (`pyr_min`, `pyr_flat`): a ray under the block by the margin leaves the
    block in one step, to the level-0 cell the walk would enter there
    (`block_crossing`, with the same t: the running max of exits is the
    block's exit); otherwise the step descends a level, the cell staying
    the same. A ray that passes under a cell or a block ascends by the
    crossed boundary's alignment, as the max-mip march ascends after a skip
    (no other step ascends). Escape above the map ends a ray as in
    `l0_step`, and so does a descending ray under `below`'s zfloor. The
    steps and tests, and the planes of a ray that ends as a miss, are this
    walk's own.

    `below` is `below_margins(...)` (None: no test under the terrain and no
    floor). `hierarchy=False` is the walk of the kernel's lane groups
    (`l0_group_march`): `l0_step` plus the floor exit, every lane taken at
    level 0 and `lvl` left as it is. ray, st, corners and gmax as in
    `l0_step`; `counter` records the step's work."""
    ox, oy, oz, dx, dy, dz, inv_x, inv_y, t1 = ray
    t, icx, icy, act = st["t"], st["icx"], st["icy"], st["alive"]
    lvl = st["lvl"] if hierarchy else torch.zeros_like(st["lvl"])
    fine = lvl == 0
    bx, by = icx >> lvl, icy >> lvl
    t_exit, nx, ny, bnd = step_geometry(ox, oy, dx, dy, bx, by, lvl, inv_x, inv_y)
    t_exit_c = torch.minimum(t_exit, t1)
    za, zb = t * dz, t_exit_c * dz
    zmin = oz + torch.minimum(za, zb)

    z00, z10, z01, z11 = corners(icx, icy)
    cmax0 = torch.maximum(torch.maximum(z00, z10), torch.maximum(z01, z11))
    idx = _cell_index0(m, icx, icy)
    hi, lo = cmax0, torch.minimum(torch.minimum(z00, z10), torch.minimum(z01, z11))
    if hierarchy:
        side_m1 = (m >> lvl) - 1
        bidx = flat_index(m, lvl, torch.minimum(torch.clamp_min(by, 0), side_m1),
                          torch.minimum(torch.clamp_min(bx, 0), side_m1))
        idx = torch.where(fine, idx, bidx)
        hi = torch.where(fine, hi, pyr_flat.index_select(0, idx))
        lo = torch.where(fine, lo, pyr_min.index_select(
            0, torch.clamp(idx - m * m, 0, min_flat_size(m) - 1)))
    under = torch.zeros_like(act)
    if below is not None:
        m0, m1, zfloor = below
        if hierarchy:
            under = oz + torch.maximum(za, zb) + (m0 + (hi - lo) * m1) < lo
    above = fine & (zmin > hi)
    test = act & fine & ~above & ~under
    if counter is not None:
        counter.observe(act, idx, test, icx, icy)
    h, t_c = intersector(ox, oy, oz, dx, dy, dz, icx, icy, z00, z10, z01, z11,
                         t - T_TOL, t_exit_c + T_TOL)
    hit_now = h & test
    descend = act & ~fine & ~under
    advance = act & ~hit_now & ~descend

    new_t = torch.maximum(t, t_exit_c)
    new_icx, new_icy = nx, ny
    cross = advance & ~fine
    if bool(cross.any()):  # a block passed under: the level-0 cell past it
        k = torch.nonzero(cross).squeeze(1)
        sub = tuple(x.index_select(0, k) for x in ray)
        cx, cy = block_crossing(sub, *(x.index_select(0, k) for x in (icx, icy, lvl, t_exit,
                                                                        nx, ny)),
                                levels=levels)
        new_icx = nx.index_copy(0, k, cx)
        new_icy = ny.index_copy(0, k, cy)
    asc = torch.where(advance & under, ascent_levels(bnd), 0)
    new_lvl = torch.where(descend, lvl - 1, lvl + torch.minimum(asc, (levels - 1) - lvl))
    z_new = oz + new_t * dz
    ends = ((t_exit >= t1 - EPS_EXIT) | (new_icx < 0) | (new_icx >= m) | (new_icy < 0)
            | (new_icy >= m) | ((z_new > gmax) & (dz > 0.0)))
    if below is not None:
        ends = ends | (z_new < zfloor)
    out = advance & ends
    return dict(st,
                t=torch.where(advance, new_t, t),
                lvl=torch.where(act, new_lvl, lvl) if hierarchy else st["lvl"],
                icx=torch.where(advance, new_icx, icx),
                icy=torch.where(advance, new_icy, icy),
                alive=act & ~hit_now & ~out,
                hit=st["hit"] | hit_now,
                t_hit=torch.where(hit_now, t_c, st["t_hit"]),
                hx=torch.where(hit_now, icx, st["hx"]),
                hy=torch.where(hit_now, icy, st["hy"]))


def _axis_exit(b0, k, step, o, inv, none):
    """The boundary exit of the level-0 DDA k cells along one axis from
    boundary index b0 (`step_geometry`'s tx or ty of that cell, the same
    expression), BIG_T on an axis the ray does not cross."""
    return torch.where(none, BIG_T, ((b0 + k * step).to(torch.float32) * 1.0 - o) * inv)


def l0_group_march(ray, st, corners, gmax, *, m: int, intersector, group: int,
                   budget: int, counter: WorkCounter | None = None, zfloor=None):
    """The forced-level-0 tail as the CUDA kernel's lane groups march it
    (`march_common.cuh::l0_group_steps`), written on tensors: up to
    `budget` steps of every alive lane, `group` cells of a lane's level-0
    DDA a window. Not on any render path: the tests hold it against
    `l0_min_step(hierarchy=False)` iterated in every plane, and in hits
    against `l0_step` and JAX's step, bit for bit. `zfloor` (f32[P], from
    `below_margins`, or None): a descending lane under it after a cell ends
    there, as `l0_min_step` ends it.

    Each window, column k of a lane takes the cell k steps on from its
    current one: its x-steps among those k are the merge of the x and y
    boundary exit sequences (x first on a tie, as `step_geometry`), found
    by binary search; its exit, skip, exact and out tests are `l0_step`'s;
    the t it enters at is the prefix max of the earlier columns' exits (a
    log-step scan, the kernel's order). The first column that ends the
    lane (a hit, out, or past the budget) gives the lane its state, as
    `l0_step` leaves it after that cell; with none, the lane moves on
    `group` cells. ray, st and corners as in `l0_step`; returns the new st.
    `counter` records each window's steps and cell tests."""
    ox, oy, oz, dx, dy, dz, inv_x, inv_y, t1 = (x[:, None] for x in ray)
    G = group
    dev = ox.device
    k = torch.arange(G, dtype=torch.int32, device=dev)[None, :]
    pos_x, pos_y = dx > 0.0, dy > 0.0
    step_x = torch.where(pos_x, 1, -1).to(torch.int32)
    step_y = torch.where(pos_y, 1, -1).to(torch.int32)
    none_x, none_y = torch.abs(dx) < 1e-20, torch.abs(dy) < 1e-20
    st = dict(st)
    used = torch.zeros(ox.shape[0], dtype=torch.int32, device=dev)
    while True:
        act = st["alive"] & (used < budget)
        if not bool(act.any()):
            return st
        t, icx, icy = st["t"][:, None], st["icx"][:, None], st["icy"][:, None]
        bx0, by0 = icx + pos_x.to(torch.int32), icy + pos_y.to(torch.int32)
        # the smallest i in [0, k] with not tx(i) <= ty(k - 1 - i)
        lo, hi = torch.zeros_like(k).expand(icx.shape[0], G), k.expand(icx.shape[0], G)
        for _ in range(G.bit_length()):
            go = lo < hi
            mid = (lo + hi) >> 1
            later = ~(_axis_exit(bx0, mid, step_x, ox, inv_x, none_x)
                      <= _axis_exit(by0, k - 1 - mid, step_y, oy, inv_y, none_y))
            hi = torch.where(go & later, mid, hi)
            lo = torch.where(go & ~later, mid + 1, lo)
        cx, cy = icx + lo * step_x, icy + (k - lo) * step_y
        t_exit, nx, ny, _ = step_geometry(ox, oy, dx, dy, cx, cy, 0, inv_x, inv_y)
        t_exit_c = torch.minimum(t_exit, t1)
        inc = t_exit_c
        d = 1
        while d < G:
            o = torch.cat([inc[:, :d], inc[:, :-d]], 1)
            inc = torch.where(k >= d, torch.maximum(inc, o), inc)
            d <<= 1
        before = torch.cat([inc[:, :1], inc[:, :-1]], 1)
        t_k = torch.where(k == 0, t, torch.maximum(t, before))
        zmin = oz + torch.minimum(t_k * dz, t_exit_c * dz)
        z = tuple(x.reshape(cx.shape)
                  for x in corners(cx.reshape(-1), cy.reshape(-1)))
        cmax = torch.maximum(torch.maximum(z[0], z[1]), torch.maximum(z[2], z[3]))
        run = act[:, None] & (k < (budget - used)[:, None])
        test = run & ~(zmin > cmax)
        h, t_c = intersector(ox, oy, oz, dx, dy, dz, cx, cy, *z, t_k - T_TOL, t_exit_c + T_TOL)
        hit_now = h & test
        t_new = torch.maximum(t, inc)
        z_new = oz + t_new * dz
        out = ((t_exit >= t1 - EPS_EXIT) | (nx < 0) | (nx >= m) | (ny < 0) | (ny >= m)
               | ((z_new > gmax) & (dz > 0.0)))
        if zfloor is not None:
            out = out | (z_new < zfloor[:, None])
        ends = ~run | hit_now | out
        # the first column that ends the lane, G if none; the cells stepped
        f = torch.where(ends.any(1), torch.argmax(ends.to(torch.int32), 1), G)[:, None]
        fc = torch.clamp(f, max=G - 1)

        def at(x):
            return x.gather(1, fc).squeeze(1)

        f_run, f_hit = at(run), at(hit_now)
        none = f.squeeze(1) == G
        taken = torch.where(none, G, f.squeeze(1) + f_run.to(torch.int32))
        if counter is not None:
            stepped = act[:, None] & (k < taken[:, None])
            counter.observe(stepped, _cell_index0(m, cx, cy), stepped & test, cx, cy)
        out_f = ~none & f_run & ~f_hit
        stand = ~none & ~out_f  # a hit in cell f, or the budget spent before it
        last = torch.full_like(fc, G - 1)

        def pick(x_none, x_out, x_stand):
            return torch.where(none, x_none, torch.where(out_f, x_out, x_stand))

        new_t = pick(t_new.gather(1, last).squeeze(1), at(t_new), at(t_k))
        new_icx = pick(nx.gather(1, last).squeeze(1), at(nx), at(cx))
        new_icy = pick(ny.gather(1, last).squeeze(1), at(ny), at(cy))
        hit_l = act & stand & f_hit
        st = dict(st,
                  t=torch.where(act, new_t, st["t"]),
                  icx=torch.where(act, new_icx, st["icx"]),
                  icy=torch.where(act, new_icy, st["icy"]),
                  alive=st["alive"] & ~(act & (out_f | (stand & f_hit))),
                  hit=st["hit"] | hit_l,
                  t_hit=torch.where(hit_l, at(t_c), st["t_hit"]),
                  hx=torch.where(hit_l, at(cx), st["hx"]),
                  hy=torch.where(hit_l, at(cy), st["hy"]))
        used = used + torch.where(act, taken, 0).to(torch.int32)


def relaxed_planes(t):
    """The relaxed step's own lane planes at the start of a tail pass:
    rmode 0 (sampling), tprev = t (the last sample above), wend = BIG_T
    (the bracket's end), as `hmrt_tpu/kernels/compact.py` sets them."""
    return dict(rmode=torch.zeros(t.shape, dtype=torch.int32, device=t.device),
                tprev=t.clone(), wend=torch.full_like(t, BIG_T))


def l0_step_relaxed(ray, st, corners, gmax, *, m: int, intersector, surface,
                    stride: int, counter: WorkCounter | None = None):
    """One masked step of the RELAXED level-0 tail
    (`hmrt_tpu/kernels/march_body.py::wavefront_step_l0_relaxed`). Not
    exact; opt-in.

    Mode A (rmode 0, stride sampling): compare the ray's height with the
    cell surface (`surface`, the evaluator of `intersector`'s own surface)
    at the current sample point; while above, jump `stride` cells along the
    dominant axis. A sample below starts mode B from the last sample above.
    Mode B (rmode 1, the exact walk): the level-0 DDA with the exact test in
    every cell (no skip test), up to the sample that was below; past it
    without a hit, back to mode A from where the walk stands.

    A sample below implies a crossing in the bracket, so a detected hit is
    the exact hit with the exact t, and there are no false hits; a feature
    narrower than `stride` cells along the ray can be tunnelled.

    st also holds the planes rmode, tprev and wend (`relaxed_planes`).
    `counter` counts every step, and the walk's intersector calls as cell
    tests."""
    ox, oy, oz, dx, dy, dz, inv_x, inv_y, t1 = ray
    t, icx, icy, act = st["t"], st["icx"], st["icy"], st["alive"]
    rmode, tprev, wend = st["rmode"], st["tprev"], st["wend"]

    # bracket passed without a hit -> sample again from where the walk stands
    exhaust = act & (rmode != 0) & (t > wend + T_TOL)
    rmode = torch.where(exhaust, 0, rmode)
    tprev = torch.where(exhaust, t, tprev)
    walk = act & (rmode != 0)
    samp = act & (rmode == 0)

    z00, z10, z01, z11 = corners(icx, icy)

    # mode B: the exact walk (the expressions of l0_step)
    t_exit, nx, ny, _ = step_geometry(ox, oy, dx, dy, icx, icy, 0, inv_x, inv_y)
    t_exit_c = torch.minimum(t_exit, t1)
    h, t_c = intersector(ox, oy, oz, dx, dy, dz, icx, icy, z00, z10, z01, z11,
                         t - T_TOL, t_exit_c + T_TOL)
    hit_now = h & walk
    wadv = walk & ~hit_now
    wt = torch.maximum(t, t_exit_c)
    wesc = wadv & (oz + wt * dz > gmax) & (dz > 0.0)
    wout = (wadv & ((t_exit >= t1 - EPS_EXIT)
                    | (nx < 0) | (nx >= m) | (ny < 0) | (ny >= m))
            | wesc)

    # mode A: a sample at the current position
    zs = surface(ox + t * dx - icx.to(torch.float32), oy + t * dy - icy.to(torch.float32),
                 z00, z10, z01, z11)
    below = samp & (oz + t * dz <= zs)
    above = samp & ~below
    stride_t = stride * torch.minimum(torch.abs(inv_x), torch.abs(inv_y))
    ts_new = torch.maximum(t, torch.minimum(t + stride_t, t1 - EPS_EXIT))
    sout = above & (t >= t1 - 2.0 * EPS_EXIT)
    sesc = above & (oz + ts_new * dz > gmax) & (dz > 0.0)
    sadv = above & ~sout & ~sesc
    if counter is not None:
        counter.observe(act, _cell_index0(m, icx, icy), walk, icx, icy)

    new_t = torch.where(below, tprev,
                        torch.where(sadv, ts_new, torch.where(wadv, wt, t)))
    new_icx = torch.where(below, floor_cell(ox + tprev * dx, m),
                          torch.where(sadv, floor_cell(ox + ts_new * dx, m),
                                      torch.where(wadv, nx, icx)))
    new_icy = torch.where(below, floor_cell(oy + tprev * dy, m),
                          torch.where(sadv, floor_cell(oy + ts_new * dy, m),
                                      torch.where(wadv, ny, icy)))
    dead = hit_now | wout | sout | sesc
    return dict(st, t=new_t, icx=new_icx, icy=new_icy,
                rmode=torch.where(below, 1, rmode),
                tprev=torch.where(sadv, t, tprev),
                wend=torch.where(below, t, wend),
                alive=act & ~dead,
                hit=st["hit"] | hit_now,
                t_hit=torch.where(hit_now, t_c, st["t_hit"]),
                hx=torch.where(hit_now, icx, st["hx"]),
                hy=torch.where(hit_now, icy, st["hy"]))


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
                 any_hit: bool = False,
                 clip: tuple | None = None,
                 cone_flat=None, cone_radius: int = 0,
                 counter: WorkCounter | None = None) -> MarchResult:
    """Masked-wavefront maximum-mipmap march over a batch of f32[P] rays,
    descending from level `start_level` (default: the pyramid top). The
    shadow march is the same traversal; its caller reads only `hit`
    (`any_hit`, as in the JAX package, changes nothing).

    `cone_flat`/`cone_radius`: the conservative cone field of core/cone.py
    (flat (n*n,) f32) and its radius; level-0 lanes whose exact test misses
    then take its multi-cell safe jumps, with the same hits. No render path
    uses it. `counter` records the march's work."""
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
    cone = None if cone_flat is None else (cone_flat, cone_radius)
    st = run_masked(lambda s: maxmip_step(ray, s, pyr_flat, heights_flat, gmax,
                                          n=n, m=m, levels=levels,
                                          intersector=intersector, counter=counter,
                                          cone=cone),
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
