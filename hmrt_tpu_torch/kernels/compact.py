"""Compacted-wavefront renderer: budgeted march passes + ray sorting.

Counterpart of the legacy flow of `hmrt_tpu/kernels/compact.py`
(`fold_inv=False`). Rays are generated and initialised in torch, and the
ray state lives in flat per-lane planes. A march pass (`march_pass`, CUDA
kernel 1) steps every live ray up to a budget. Between passes the
survivors are SORTED by their current 32-cell terrain column (one argsort
and one gather of the moving planes), so the rays of a thread block march
through nearby terrain; the last round is unbudgeted, so every ray
resolves. Results return to launch order by one scatter through the
composed permutation. The shade pass (`shade_pass`, CUDA kernel 2) then
runs in launch order, the shadow march repeats the sorted rounds from the
hit cells, and the final colour maths is plain torch.

The schedule only decides which rays march when: any (first_budget,
rounds, round_budget) gives the same frame, because each ray's march is
deterministic and independent of the others. The TPU package's other
knobs (n_col, subserve, band_tail, unroll, banks, sort_dir, sort_mode,
fold_inv, coarse0, prefix schedules) tuned its Mosaic schedule and are not
ported.

The tail, as in the JAX package: the last sorted round of the primary and
of the shadow march may run as the forced-level-0 tail (`l0_tail`). Its
survivors are first descended to the level-0 cell at their position
(`force_level0`, so the sort key is their level-0 column), then march the
level-0 DDA with the exact test, skipping no cell whose max they do not
clear, but passing under whole blocks of the min pyramid (march_pass.py).
That gives up skips the max pyramid could still take and never changes a
hit, so every `l0_tail` gives the same frame. "auto" forces the tail when
more than L0_TAIL_AUTO_THRESH of the survivors are already at level 0,
decided on the device (a flag the kernel reads), with no host wait. `relax=k` runs the
relaxed stride tail there instead: not exact (a feature narrower than k
cells along a ray can be tunnelled; no false hits), opt-in.
"""

from __future__ import annotations

import torch

from hmrt_tpu_torch.config import RenderConfig
from hmrt_tpu_torch.core.renderer import SHADOW_EPS
from hmrt_tpu_torch.kernels.march_pass import UNBUDGETED, march_pass
from hmrt_tpu_torch.kernels.shade_pass import shade_pass
from hmrt_tpu_torch.shading import shade as sh
from hmrt_tpu_torch.traversal.intersect import BIG_T
from hmrt_tpu_torch.traversal.march import entry_cell, ray_box_range
from hmrt_tpu_torch.types import Camera, Frame, Scene

BIG_KEY = 2 ** 30   # sort key of a dead lane: after every live column

#: Default schedule. Pass 0 in launch order resolves sky and near hits
#: cheaply; each later round first sorts the survivors by terrain column.
#: Chosen as a simple start, not tuned yet on the H100 (see PERF.md).
FIRST_BUDGET = 64
ROUNDS = 2
ROUND_BUDGET = 256

#: l0_tail="auto": the share of surviving rays already at level 0 (before
#: the last sorted round) above which the tail is forced to level 0; the
#: JAX package's value (hmrt_tpu/kernels/compact.py). Both choices are exact.
L0_TAIL_AUTO_THRESH = 0.9


def primary_rays(camera: Camera, config: RenderConfig, row0: int | None = None,
                 full_height: int | None = None):
    """Launch-order ray planes (ox, oy, oz, dx, dy, dz), each f32[H*W].
    `row0`/`full_height`: the rays of rows [row0, row0 + H) of a
    full_height-row screen, the same bits as those rows of the full grid."""
    eye, dirs = camera.rays(config.height, config.width, row0, full_height)
    d = dirs.reshape(-1, 3)
    p = d.shape[0]
    return (tuple(eye[i].expand(p).contiguous() for i in range(3))
            + tuple(d[:, i].contiguous() for i in range(3)))


def init_state(rays, valid0, gmax, *, n: int, m: int, levels: int,
               clip=None, start_cell=None):
    """Initial march state (alive, t, lvl, icx, icy), with the sky
    early-out. `start_cell=(cx, cy)`: begin at level 0 in that cell
    instead of at the pyramid top (the shadow rays, whose origins sit in
    the primary hit cells; any start level is exact)."""
    ox, oy, oz, dx, dy, dz = rays
    t0, _, valid = ray_box_range(ox, oy, dx, dy, float(n - 1), clip)
    if valid0 is not None:
        valid = valid & valid0
    valid = valid & ~((oz + t0 * dz > gmax) & (dz >= 0.0))
    if start_cell is not None:
        lvl = torch.zeros_like(start_cell[0])
        icx = torch.clamp(start_cell[0], 0, m - 1)
        icy = torch.clamp(start_cell[1], 0, m - 1)
    else:
        lvl = torch.full(ox.shape, levels - 1, dtype=torch.int32, device=ox.device)
        icx, icy = entry_cell(ox, oy, dx, dy, t0, levels - 1, 1)
    return (valid.to(torch.int32), torch.where(valid, t0, BIG_T), lvl, icx, icy)


def force_level0(rays, state):
    """Descend every lane to the level-0 cell containing its position at t,
    as `levels - 1` masked rounds of `descend_cell` do
    (`hmrt_tpu/kernels/compact.py::_force_level0`). Descending without a
    test is always exact (the skip test only skips when certain, and this
    skips nothing), so the level-0 tail stays exact; a lane that could
    still have taken pyramid skips now steps cell by cell.

    Those rounds are a binary search of the position inside the lane's
    cell: each compares it with the midpoint of the current cell, an
    integer that f32 holds exactly. So the cell they reach is floor(p)
    clamped to the level-0 cells under the lane's cell, which this computes
    in one pass of torch over the planes, on any device, bit for bit the
    same (tests/test_torch_relaxed.py holds it against the JAX rounds)."""
    ox, oy, _, dx, dy, _ = rays
    alive, t, lvl, icx, icy = state

    def descend(o, d, c):
        lo = c << lvl
        hi = lo + (1 << lvl) - 1
        f = torch.floor(o + t * d)
        return torch.clamp(f, lo.to(torch.float32), hi.to(torch.float32)).to(torch.int32)

    return alive, t, torch.zeros_like(lvl), descend(ox, dx, icx), descend(oy, dy, icy)


def l0_tail_flag(state):
    """The "auto" tail's choice, a 0-dim bool on the planes' device: more
    than L0_TAIL_AUTO_THRESH of the alive lanes are at level 0."""
    alive = state[0] != 0
    n_alive = alive.sum()
    n_l0 = (alive & (state[2] == 0)).sum(dtype=torch.int32)
    return n_l0 > (L0_TAIL_AUTO_THRESH * n_alive.to(torch.float32)).to(torch.int32)


def check_l0_tail(l0_tail, relax: int) -> None:
    """Raise unless l0_tail is True, False or "auto" and relax fits it."""
    if l0_tail not in (True, False, "auto"):
        raise ValueError(f"l0_tail must be True, False or 'auto', not {l0_tail!r}")
    if relax < 0:
        raise ValueError(f"relax {relax} < 0")
    if relax and l0_tail is False:
        # without the tail relax would do nothing and the frame would be exact
        raise ValueError("relax > 0 needs the level-0 tail (l0_tail=True, or 'auto' to "
                         "relax only when the tail is chosen)")


def column_key(state, m5: int):
    """Sort key: the 32-cell terrain column of each live lane's current
    cell (at any level); dead lanes key BIG_KEY."""
    alive, _, lvl, icx, icy = state
    colx = torch.clamp((icx << lvl) >> 5, 0, m5 - 1)
    coly = torch.clamp((icy << lvl) >> 5, 0, m5 - 1)
    return torch.where(alive != 0, coly * m5 + colx, BIG_KEY)


def march_rounds(rays, state, scene: Scene, *, cell_intersect: str, clip,
                 first_budget: int, rounds: int, round_budget: int,
                 moving: tuple, skip_pass0: bool = False, counts: list | None = None,
                 l0_tail: bool | str = "auto", relax: int = 0):
    """Pass 0 in launch order, then `rounds` sorted rounds (the last one
    unbudgeted, and the tail under `l0_tail`/`relax`, module docstring).
    `moving` names the ray planes that differ per ray and so ride the sort;
    the others are one value broadcast. Returns the result planes (hit,
    t_hit, hx, hy) in launch order. `counts`, a list, takes each pass's
    (2, P) per-ray steps and cell tests, in that pass's lane order
    (march_pass's counting instance)."""
    check_l0_tail(l0_tail, relax)
    p = rays[0].shape[0]
    res = empty_results(p, rays[0].device)
    kw = dict(n=scene.n, m=scene.m, levels=scene.levels,
              cell_intersect=cell_intersect, clip=clip)

    def run(rays, state, res, budget, tail=False):
        cnt = None
        if counts is not None:
            cnt = torch.empty((2, p), dtype=torch.int32, device=rays[0].device)
            counts.append(cnt)
        return march_pass(rays, state, res, scene.pyr_flat, scene.heights, scene.corners,
                          budget=budget, counts=cnt, l0_only=tail,
                          relax=0 if tail is False else relax,
                          pyr_min=scene.pyr_min_flat, **kw)

    if not skip_pass0 and first_budget > 0:
        state, res = run(rays, state, res, first_budget)
    m5 = max(scene.m // 32, 1)
    perm_tot = None
    for r in range(rounds):
        tail = False
        if r == rounds - 1 and l0_tail:
            # force level 0 before the sort, so the sort key is the tail's column
            forced = force_level0(rays, state)
            if l0_tail == "auto":
                tail = l0_tail_flag(state)
                forced = tuple(torch.where(tail, f, s) for f, s in zip(forced, state))
            else:
                tail = True
            state = forced
        perm = torch.argsort(column_key(state, m5))
        rays = tuple(x.index_select(0, perm) if i in moving else x
                     for i, x in enumerate(rays))
        state = tuple(x.index_select(0, perm) for x in state)
        res = tuple(x.index_select(0, perm) for x in res)
        perm_tot = perm if perm_tot is None else perm_tot.index_select(0, perm)
        state, res = run(rays, state, res,
                         UNBUDGETED if r == rounds - 1 else round_budget, tail)
    # back to launch order: lane k of the sorted planes is launch lane perm_tot[k]
    return tuple(torch.empty_like(x).index_copy_(0, perm_tot, x) for x in res)


def march_shadows(srays, sstate, scene: Scene, *, cell_intersect: str, clip,
                  first_budget: int = FIRST_BUDGET, rounds: int = ROUNDS,
                  round_budget: int = ROUND_BUDGET, counts: list | None = None,
                  l0_tail: bool | str = "auto", relax: int = 0):
    """The shadow march of a compact frame: min(rounds, 2) sorted rounds
    from the rays' start state and no pass 0, the last one the tail as in
    `march_rounds`. Only the origin planes differ per ray (the direction is
    the sun's). Returns the hit plane in launch order; `counts` as in
    `march_rounds`."""
    return march_rounds(srays, sstate, scene, cell_intersect=cell_intersect, clip=clip,
                        first_budget=first_budget, rounds=min(rounds, 2),
                        round_budget=round_budget, moving=(0, 1, 2), skip_pass0=True,
                        counts=counts, l0_tail=l0_tail, relax=relax)[0]


def hit_points(rays, hit, t_hit, hx, hy):
    """World hit points (px, py, pz) and the offsets (fx, fy) inside the
    hit cell, clamped to [0, 1]."""
    ox, oy, oz, dx, dy, dz = rays
    ts = torch.where(hit, t_hit, 0.0)
    px = ox + ts * dx
    py = oy + ts * dy
    pz = oz + ts * dz
    fx = torch.clamp(px - hx.to(torch.float32), 0.0, 1.0)
    fy = torch.clamp(py - hy.to(torch.float32), 0.0, 1.0)
    return (px, py, pz), fx, fy


def shadow_start(points, normal, hit, hx, hy, scene: Scene, clip=None):
    """Shadow rays toward the sun from just above each hit point (offset
    by SHADOW_EPS along the sun and the normal; misses are parked outside
    the map), and their initial state at level 0 in the hit cell."""
    px, py, pz = points
    nx, ny, nz = normal
    lx, ly, lz = scene.light.sun_dir[0], scene.light.sun_dir[1], scene.light.sun_dir[2]
    p = px.shape[0]
    sxo = px + lx * SHADOW_EPS + nx * SHADOW_EPS
    syo = py + ly * SHADOW_EPS + ny * SHADOW_EPS
    szo = pz + lz * SHADOW_EPS + nz * SHADOW_EPS
    srays = (torch.where(hit, sxo, -1e6), torch.where(hit, syo, -1e6), szo,
             lx.expand(p).contiguous(), ly.expand(p).contiguous(),
             lz.expand(p).contiguous())
    sstate = init_state(srays, hit, scene.pyr_flat[-1], n=scene.n, m=scene.m,
                        levels=scene.levels, clip=clip, start_cell=(hx, hy))
    return srays, sstate


def empty_results(p: int, dev):
    """Result planes (hit, t_hit, hx, hy) of P rays that have not hit."""
    return (torch.zeros(p, dtype=torch.int32, device=dev),
            torch.full((p,), BIG_T, dtype=torch.float32, device=dev),
            torch.zeros(p, dtype=torch.int32, device=dev),
            torch.zeros(p, dtype=torch.int32, device=dev))


def shade_frame(scene: Scene, config: RenderConfig, rays, hit_i, t_hit, hx, hy, *,
                shade, shadow_hits):
    """Shade data, shadow rays and the colour maths for primary march
    results in launch order. `shade` is `shade_pass` or its plain version;
    `shadow_hits(srays, sstate)` marches the shadow rays to the end and
    returns their hit plane. Returns flat (color[P,3] clipped to [0, 1],
    depth[P], normal[P,3], hit[P] bool)."""
    dx, dy, dz = rays[3:]
    hit = hit_i != 0
    points, fx, fy = hit_points(rays, hit, t_hit, hx, hy)
    nx, ny, nz, ar, ag, ab = shade(hit_i, hx, hy, fx, fy, scene.shade_rec,
                                   scene.albedo_rec if config.texture else None)

    light = scene.light
    lx, ly, lz = light.sun_dir[0], light.sun_dir[1], light.sun_dir[2]
    diff = sh.lambert(nx, ny, nz, lx, ly, lz)

    if config.shadows:
        srays, sstate = shadow_start(points, (nx, ny, nz), hit, hx, hy, scene,
                                     config.clip_box)
        occ = shadow_hits(srays, sstate) != 0
        diff = torch.where(occ, 0.0, diff)

    sr, sg, sb = light.sun_color[0], light.sun_color[1], light.sun_color[2]
    r = ar * (config.ambient + diff * sr)
    g = ag * (config.ambient + diff * sg)
    b = ab * (config.ambient + diff * sb)
    if config.shading == "phong":
        spec = sh.phong_specular(nx, ny, nz, lx, ly, lz, -dx, -dy, -dz,
                                 config.shininess)
        if config.shadows:
            spec = torch.where(occ, 0.0, spec)
        r = r + config.specular * spec * sr
        g = g + config.specular * spec * sg
        b = b + config.specular * spec * sb
    if config.fog:
        r, g, b = sh.apply_fog(r, g, b, torch.where(hit, t_hit, 0.0),
                               config.fog_density, light.fog_color)
    skyr, skyg, skyb = sh.sky_color(dz, light.sky_top, light.sky_horizon)
    color = torch.stack([torch.where(hit, c, s) for c, s in
                         ((r, skyr), (g, skyg), (b, skyb))], dim=-1)
    normal = torch.stack([torch.where(hit, c, 0.0) for c in (nx, ny, nz)], dim=-1)
    return (torch.clamp(color, 0.0, 1.0), torch.where(hit, t_hit, torch.inf), normal,
            hit)


def to_frame(config: RenderConfig, color, depth, normal, hit) -> Frame:
    """A Frame of config's (height, width) from flat or planar buffers;
    depth and normal only with aux_buffers."""
    H, W = config.height, config.width
    return Frame(color=color.reshape(H, W, 3),
                 depth=depth.reshape(H, W) if config.aux_buffers else None,
                 normal=normal.reshape(H, W, 3) if config.aux_buffers else None,
                 hit=hit.reshape(H, W))


def render_frame_compact(scene: Scene, camera: Camera, config: RenderConfig, *,
                         first_budget: int = FIRST_BUDGET, rounds: int = ROUNDS,
                         round_budget: int = ROUND_BUDGET, counts: dict | None = None,
                         row0: int | None = None, full_height: int | None = None,
                         l0_tail: bool | str = "auto", relax: int = 0) -> Frame:
    """Compacted-wavefront render (see the module docstring).

    first_budget: steps of pass 0 in launch order (0 skips it);
    rounds: sorted rounds, the last unbudgeted (at least 1);
    round_budget: steps of each earlier sorted round.
    The shadow march takes min(rounds, 2) sorted rounds and no pass 0.
    l0_tail: True forces the last round of each march to the level-0 tail,
    "auto" (the default) when more than L0_TAIL_AUTO_THRESH of its rays are
    already at level 0, False never; the frame is the same for each.
    relax: stride in cells of the relaxed tail (0, the default: exact). Its
    contract: no false hits; a detected hit is the exact hit with the exact
    t; a feature narrower than `relax` cells along a ray can be tunnelled
    (a missed or later hit). It needs the tail: with l0_tail=False it
    raises; with "auto" it relaxes only the marches whose tail is chosen.
    counts: a dict whose "primary" and "shadow" lists take each march
    launch's per-ray steps and cell tests (`march_rounds`; bench/floor.py).
    row0/full_height: render rows [row0, row0 + height) of a
    full_height-row screen (the band form under sharding); the sort keys
    and passes then run over the band's rays alone."""
    check_l0_tail(l0_tail, relax)
    if rounds < 1 or first_budget < 0 or round_budget < 0:
        raise ValueError(f"bad schedule first_budget={first_budget} "
                         f"rounds={rounds} round_budget={round_budget}")
    if row0 is not None and not 0 <= row0 <= (full_height or config.height) - config.height:
        raise ValueError(f"row band [{row0}, {row0 + config.height}) outside a "
                         f"{full_height or config.height}-row screen")
    rays = primary_rays(camera, config, row0, full_height)
    sched = dict(cell_intersect=config.cell_intersect, clip=config.clip_box,
                 first_budget=first_budget, round_budget=round_budget, l0_tail=l0_tail,
                 relax=relax)

    state0 = init_state(rays, None, scene.pyr_flat[-1], n=scene.n, m=scene.m,
                        levels=scene.levels, clip=config.clip_box)
    counts = counts if counts is not None else {"primary": None, "shadow": None}
    hit_i, t_hit, hx, hy = march_rounds(rays, state0, scene, rounds=rounds, moving=(3, 4, 5),
                                        counts=counts["primary"], **sched)
    return to_frame(config, *shade_frame(
        scene, config, rays, hit_i, t_hit, hx, hy, shade=shade_pass,
        shadow_hits=lambda srays, sstate: march_shadows(
            srays, sstate, scene, rounds=rounds, counts=counts["shadow"], **sched)))
