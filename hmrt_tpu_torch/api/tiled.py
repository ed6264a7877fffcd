"""Out-of-core tiled rendering for maps larger than device memory.

Counterpart of `hmrt_tpu/api/tiled.py`. The map is streamed tile by tile
(from a RawTileMap or an in-memory array); each tile becomes a temporary
sub-scene on the device, the FULL frame is rendered against it with the
camera moved into tile-local coordinates, and the per-tile frames are
composited by nearest hit depth. Each sub-scene is rendered by
`render_frame` under the caller's backend, clipped to the tile's cell
window, so on the card a large tile takes the compact path and its kernels.

Exactness: every heightfield cell belongs to one tile (tiles carry a
one-sample overlap so each cell's 4 corner samples are tile-local), the
per-cell intersection maths is the same, and min-depth compositing keeps
the globally nearest hit, so the composite equals a resident render of the
same map, but for one limit of f32: the exact cell test rounds at the
magnitude of its coordinates, so at cell coordinates in the thousands a
grazing ray can slip past a cell edge in the tile's frame and not in the
map's, or the other way round (a few pixels in a million on B4; ROADMAP.md
section 3).

Shadows: a shadow ray's occluder may live in another tile than the hit, so
the shadowed frame runs in three stages: (1) the per-tile geometry
composite (hit, t, normal); (2) a second tile sweep marching every shadow
ray clipped to the tile's cell window and OR-ing the occlusion, with the
march of the compact path (`march_shadows`: the kernel on the card, its
plain version on the CPU); (3) one global shading pass with the
expressions of `core/renderer.py::shade_hits`, the albedo sampled from the
caller's full array.

Stage spans (utils/profiling.py, while the port's tracing is armed):
"hmrt.tiled.cut" (the tiles, their boxes, order and cull probes),
"hmrt.tiled.build" (a tile's load and sub-scene build), "hmrt.tiled.render"
(a tile's render and composite) and "hmrt.tiled.shadow" (a tile's shadow
march, with its build inside).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from hmrt_tpu_torch.api.scene import make_scene
from hmrt_tpu_torch.config import RenderConfig
from hmrt_tpu_torch.core.renderer import render_frame
from hmrt_tpu_torch.device import resolve
from hmrt_tpu_torch.shading import shade as sh
from hmrt_tpu_torch.types import Camera, Frame, Light
from hmrt_tpu_torch.utils.profiling import span


class TileSceneCache:
    """LRU cache of tile sub-scenes, keyed by (y0, x0, kind).

    A shadowed frame builds every visible tile's scene twice (primary
    composite, then the shadow sweep), and an animation rebuilds them every
    frame. Caching changes no pixel and is bounded: at most `max_tiles`
    sub-scenes stay resident. The cache is valid for ONE (source, albedo,
    device) triple; pass a fresh cache when one changes."""

    def __init__(self, max_tiles: int):
        self.max_tiles = int(max_tiles)
        self._d: OrderedDict = OrderedDict()
        self.built = 0  # scenes built, for _stats

    def get(self, key, build):
        if key in self._d:
            self._d.move_to_end(key)
            return self._d[key]
        scene = build()
        self.built += 1
        if self.max_tiles > 0:
            self._d[key] = scene
            while len(self._d) > self.max_tiles:
                self._d.popitem(last=False)
        return scene

    def peek(self, key):
        if key in self._d:
            self._d.move_to_end(key)
            return self._d[key]
        return None


def _tile_axis(side: int, tile: int):
    """Tile origins along one axis. Every tile spans exactly `tile` cells
    (tile+1 samples): a non-aligned final tile is SHIFTED back to overlap
    its neighbour rather than shrunk, so no tile holds cells beyond the map
    edge and overlapped cells are identical duplicates."""
    n_cells = side - 1
    if n_cells <= tile:
        return [0]
    xs = list(range(0, n_cells - tile, tile))
    xs.append(n_cells - tile)
    return xs


def _tile_origins(side: int, tile: int):
    for y0 in _tile_axis(side, tile):
        for x0 in _tile_axis(side, tile):
            yield y0, x0


def _ray_box_tmin(ox, oy, oz, dx, dy, dz, box):
    """Conservative per-ray AABB slab test in the frame's ray
    parameterisation (p = o + t*d, the t of Frame.depth). Returns (tmin,
    intersects), tmin clamped to >= 0. Near-parallel components are clamped
    to +/-1e-12, which errs toward "intersects": the caller culls on the
    result."""
    x0, x1, y0, y1, z0, z1 = box

    def axis(o, d, lo, hi):
        d = torch.where(torch.abs(d) < 1e-12, torch.where(d < 0.0, -1e-12, 1e-12), d)
        inv = 1.0 / d
        ta = (lo - o) * inv
        tb = (hi - o) * inv
        return torch.minimum(ta, tb), torch.maximum(ta, tb)

    t0x, t1x = axis(ox, dx, x0, x1)
    t0y, t1y = axis(oy, dy, y0, y1)
    t0z, t1z = axis(oz, dz, z0, z1)
    tmin = torch.maximum(torch.maximum(t0x, t0y), torch.clamp_min(t0z, 0.0))
    tmax = torch.minimum(torch.minimum(t1x, t1y), t1z)
    return tmin, tmin <= tmax


def _tile_boxes(origins, fetch, t_cells):
    """Probe pass: each tile's conservative AABB from its (t_cells+1)^2
    interior samples, whose hull holds the surface of the marched window
    (triangle or bilinear). One extra streaming read of the map buys
    skipping whole-tile renders."""
    boxes = []
    for y0, x0 in origins:
        hts = np.asarray(fetch(y0, x0, t_cells + 1, t_cells + 1))
        boxes.append((float(x0), float(x0 + t_cells), float(y0), float(y0 + t_cells),
                      float(hts.min()), float(hts.max())))
    return boxes


def _front_to_back(origins, boxes, eye):
    """Order tiles by eye-to-AABB distance. Order is an efficiency lever
    only (compositing is min-depth), but front-to-back makes the composite
    depth tight early, so the can-improve test culls the back tiles."""
    ex, ey, ez = (float(v) for v in eye.detach().cpu())
    keyed = []
    for og, bx in zip(origins, boxes):
        ddx = max(bx[0] - ex, 0.0, ex - bx[1])
        ddy = max(bx[2] - ey, 0.0, ey - bx[3])
        ddz = max(bx[4] - ez, 0.0, ez - bx[5])
        keyed.append((ddx * ddx + ddy * ddy + ddz * ddz, og, bx))
    keyed.sort(key=lambda k: k[0])
    return [(og, bx) for _, og, bx in keyed]


def render_frame_tiled(source, camera: Camera, config: RenderConfig, *,
                       tile: int = 2048, light: Light | None = None,
                       albedo: np.ndarray | None = None, cull: bool = True,
                       cache: TileSceneCache | int = 0,
                       _stats: dict | None = None, device=None) -> Frame:
    """Render one frame against a tiled heightmap source on `device`
    (default: the CUDA card; the camera must live there too).

    source: an (N, N) float32 array in world z units, or any object with
    `.side` and `.tile(y0, x0, th, tw) -> np.ndarray` (e.g. RawTileMap).
    `tile` is the cell count per tile edge (a tile loads tile+1 samples,
    plus a margin of one sample on each edge).

    cull: probe each tile's AABB once, order tiles front-to-back, and
    render a tile only if some ray could still hit it strictly closer than
    the composite so far; the frame equals the one with cull=False.
    _stats (a dict) records tiles_total, tiles_rendered,
    shadow_tiles_marched and tiles_built.
    cache: a TileSceneCache (or a max-tile count) that keeps built
    sub-scenes across the shadow sweep and across frames; 0 = none."""
    device = resolve(device)
    if not isinstance(cache, TileSceneCache):
        cache = TileSceneCache(int(cache))
    built0 = cache.built
    if isinstance(source, np.ndarray):
        side = source.shape[0]

        def fetch(y0, x0, th, tw):
            ys = np.clip(np.arange(y0, y0 + th), 0, side - 1)
            xs = np.clip(np.arange(x0, x0 + tw), 0, side - 1)
            return np.asarray(source[np.ix_(ys, xs)], np.float32)
    else:
        side = source.side
        fetch = source.tile

    H, W = config.height, config.width
    n_cells = side - 1
    if n_cells < 1:
        raise ValueError("heightmap smaller than one cell")
    t_cells = min(tile, n_cells)
    # The margin lets gradient normals at tile seams read the true
    # neighbour samples; the march is clipped to the interior cell window
    # [1, 1 + t_cells], so margin cells are never tested. Shadowed frames
    # shade in stage 3, so the per-tile renders drop shadows.
    sub_cfg = dataclasses.replace(config, aux_buffers=True, shadows=False,
                                  clip_box=(1.0, 1.0 + t_cells))

    def load_tile(y0, x0, with_albedo):
        n_sub = t_cells + 3  # tile samples + 1 margin sample per edge
        heights = np.array(fetch(y0 - 1, x0 - 1, n_sub, n_sub))
        # Off-map margin lines (clamped duplicates) are extrapolated
        # linearly, so border-cell gradients equal the resident render's
        # clamped one-sided difference: (h[1]-h[-1])/2 = h[1]-h[0] exactly
        # when h[-1] = 2*h[0]-h[1].
        if y0 - 1 < 0:
            heights[0, :] = 2.0 * heights[1, :] - heights[2, :]
        if x0 - 1 < 0:
            heights[:, 0] = 2.0 * heights[:, 1] - heights[:, 2]
        if y0 - 1 + n_sub > side:
            heights[-1, :] = 2.0 * heights[-2, :] - heights[-3, :]
        if x0 - 1 + n_sub > side:
            heights[:, -1] = 2.0 * heights[:, -2] - heights[:, -3]
        alb = None
        if with_albedo:
            ys = np.clip(np.arange(y0 - 1, y0 - 1 + n_sub), 0, side - 1)
            xs = np.clip(np.arange(x0 - 1, x0 - 1 + n_sub), 0, side - 1)
            alb = np.asarray(albedo[np.ix_(ys, xs)], np.float32)
        return heights, alb

    # the sky image, computed once with the resident renderer's expression,
    # so a frame that culls every tile still has its colour
    lgt = light if light is not None else Light.create(device=device)
    eye_v, dirs = camera.rays(H, W)
    sky_col = torch.clamp(torch.stack(sh.sky_color(dirs[..., 2], lgt.sky_top,
                                                   lgt.sky_horizon), dim=-1), 0.0, 1.0)

    with span("hmrt.tiled.cut"):
        origins = list(_tile_origins(side, tile))
        if cull:
            ordered = _front_to_back(origins, _tile_boxes(origins, fetch, t_cells),
                                     camera.eye)
        else:
            ordered = [(og, None) for og in origins]
    dflat = dirs.reshape(-1, 3)

    best_t = torch.full((H, W), torch.inf, dtype=torch.float32, device=device)
    best_color = sky_col
    best_normal = torch.zeros((H, W, 3), dtype=torch.float32, device=device)
    any_hit = torch.zeros((H, W), dtype=torch.bool, device=device)
    rendered = 0

    for (y0, x0), box in ordered:
        if box is not None:
            with span("hmrt.tiled.cut"):
                tmin, ib = _ray_box_tmin(eye_v[0], eye_v[1], eye_v[2],
                                         dflat[:, 0], dflat[:, 1], dflat[:, 2], box)
                if not bool(torch.any(ib & (tmin < best_t.reshape(-1)))):
                    continue
        rendered += 1

        def build_full(y0=y0, x0=x0):
            heights, alb = load_tile(y0, x0, albedo is not None)
            return make_scene(heights, albedo=alb, light=light, device=device)

        with span("hmrt.tiled.build"):
            scene = cache.get((y0, x0, "full"), build_full)
        with span("hmrt.tiled.render"):
            # the camera in tile-local coordinates (the margin moves the
            # tile's origin by one more sample): an exact shift by integers
            off = torch.tensor([x0 - 1, y0 - 1, 0.0], dtype=torch.float32, device=device)
            cam_local = Camera(eye=camera.eye - off, target=camera.target - off,
                               up=camera.up, fov_y=camera.fov_y)
            fr = render_frame(scene, cam_local, sub_cfg)
            t = torch.where(fr.hit, fr.depth, torch.inf)
            closer = t < best_t
            best_color = torch.where(closer[..., None], fr.color, best_color)
            best_normal = torch.where(closer[..., None], fr.normal, best_normal)
            best_t = torch.minimum(best_t, t)
            any_hit = any_hit | fr.hit
        del scene  # the cache, if any, holds the working set

    if _stats is not None:
        _stats.update(tiles_total=len(ordered), tiles_rendered=rendered)

    if config.shadows:
        frame = _shade_shadowed(camera, config, lgt, albedo, load_tile,
                                [og for og, _ in ordered], [bx for _, bx in ordered],
                                side, t_cells, best_t, best_normal, any_hit, cache,
                                device, _stats)
    else:
        frame = Frame(color=torch.where(any_hit[..., None], best_color, sky_col),
                      depth=best_t if config.aux_buffers else None,
                      normal=(torch.where(any_hit[..., None], best_normal, 0.0)
                              if config.aux_buffers else None),
                      hit=any_hit)
    if _stats is not None:
        _stats["tiles_built"] = cache.built - built0
    return frame


def _shade_shadowed(camera, config, lgt, albedo, load_tile, origins, boxes, side,
                    t_cells, best_t, best_normal, any_hit, cache, device, _stats=None):
    """Stages 2 and 3 of the shadowed frame (module docstring): the union
    of the per-tile clipped shadow marches, then shading of the composited
    geometry with the expressions of `shade_hits`.

    With AABBs (cull=True), a tile's shadow march is skipped when no live
    shadow ray (a primary hit, not yet occluded) meets its AABB: such a
    tile can add no occlusion."""
    from hmrt_tpu_torch.core.renderer import SHADOW_EPS
    from hmrt_tpu_torch.kernels.compact import init_state, march_shadows

    H, W = config.height, config.width
    eye, dirs = camera.rays(H, W)
    d = dirs.reshape(-1, 3)
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    P = dx.shape[0]
    hit = any_hit.reshape(-1)
    ts = torch.where(hit, best_t.reshape(-1), 0.0)
    px = eye[0] + ts * dx
    py = eye[1] + ts * dy
    pz = eye[2] + ts * dz
    nrm = best_normal.reshape(-1, 3)
    nx, ny, nz = nrm[:, 0], nrm[:, 1], nrm[:, 2]
    lx, ly, lz = lgt.sun_dir[0], lgt.sun_dir[1], lgt.sun_dir[2]
    sun = tuple(c.expand(P).contiguous() for c in (lx, ly, lz))

    # stage 2: occlusion, shadow origins offset exactly as in shade_hits
    sx = px + lx * SHADOW_EPS + nx * SHADOW_EPS
    sy = py + ly * SHADOW_EPS + ny * SHADOW_EPS
    sz = pz + lz * SHADOW_EPS + nz * SHADOW_EPS
    clip = (1.0, 1.0 + t_cells)
    occ = torch.zeros(P, dtype=torch.bool, device=device)
    marched = 0
    for (y0, x0), box in zip(origins, boxes):
        with span("hmrt.tiled.shadow"):
            live = hit & ~occ
            if not bool(torch.any(live)):
                break
            if box is not None:
                _, ib = _ray_box_tmin(sx, sy, sz, *sun, box)
                if not bool(torch.any(live & ib)):
                    continue
            marched += 1
            # a cached "full" scene of the primary pass serves the shadow
            # march; otherwise build (and cache) one without the albedo
            sub = cache.peek((y0, x0, "full"))
            if sub is None:
                def build_shadow(y0=y0, x0=x0):
                    return make_scene(load_tile(y0, x0, False)[0], light=lgt, device=device)

                with span("hmrt.tiled.build"):
                    sub = cache.get((y0, x0, "shadow"), build_shadow)
            srays = (torch.where(live, sx - (x0 - 1), -1e6),
                     torch.where(live, sy - (y0 - 1), -1e6), sz.contiguous(), *sun)
            sstate = init_state(srays, live, sub.pyr_flat[-1], n=sub.n, m=sub.m,
                                levels=sub.levels, clip=clip)
            shit = march_shadows(srays, sstate, sub, cell_intersect=config.cell_intersect,
                                 clip=clip)
            occ = occ | (shit != 0)
            del sub
    if _stats is not None:
        _stats["shadow_tiles_marched"] = marched

    # stage 3: global shading of the composited geometry (as shade_hits)
    diff = torch.where(occ, 0.0, sh.lambert(nx, ny, nz, lx, ly, lz))
    if config.texture and albedo is not None:
        alb_planar = torch.from_numpy(np.ascontiguousarray(
            np.asarray(albedo, np.float32).reshape(side * side, 3).T)).to(device)
        ar, ag, ab = sh.sample_albedo(alb_planar, side, px, py)
    else:
        ar = ag = ab = torch.full_like(px, 0.55)
    amb = config.ambient
    sr, sg, sb = lgt.sun_color[0], lgt.sun_color[1], lgt.sun_color[2]
    r = ar * (amb + diff * sr)
    g = ag * (amb + diff * sg)
    b = ab * (amb + diff * sb)
    if config.shading == "phong":
        spec = sh.phong_specular(nx, ny, nz, lx, ly, lz, -dx, -dy, -dz, config.shininess)
        spec = torch.where(occ, 0.0, spec)
        ks = config.specular
        r = r + ks * spec * sr
        g = g + ks * spec * sg
        b = b + ks * spec * sb
    if config.fog:
        r, g, b = sh.apply_fog(r, g, b, ts, config.fog_density, lgt.fog_color)
    skyr, skyg, skyb = sh.sky_color(dz, lgt.sky_top, lgt.sky_horizon)
    color = torch.clamp(torch.stack([torch.where(hit, r, skyr), torch.where(hit, g, skyg),
                                     torch.where(hit, b, skyb)], dim=-1), 0.0, 1.0)
    return Frame(color=color.reshape(H, W, 3),
                 depth=best_t if config.aux_buffers else None,
                 normal=(torch.where(any_hit[..., None], best_normal, 0.0)
                         if config.aux_buffers else None),
                 hit=any_hit)
