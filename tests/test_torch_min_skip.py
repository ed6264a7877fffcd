"""The level-0 tail under the terrain, on the CPU.

The port's exact tail (`traversal/march.py::l0_min_step`, the walk of the
CUDA kernel's one-lane instance, `march_common.cuh::l0_min_steps`) passes
a ray under whole blocks of the min pyramid (`Scene.pyr_min_flat`) without
testing their cells, and ends a descending ray under the map's lowest
height. These tests hold the pyramid to a numpy min-pool, follow it
through every way a Scene is made, and hold the tail's hits (hit, t_hit,
hx, hy) bit for bit to the old walk (`l0_step`, every cell) and to JAX's
`march_body.py::wavefront_step_l0` evaluated op by op; and they show that
nothing reads the state of a ray that ended as a miss, which is the one
thing the new walk leaves elsewhere.
"""

import dataclasses
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as hs

import hmrt_tpu_torch as T
import hmrt_tpu_torch.kernels.compact as compact
from conftest import random_rays
from hmrt_tpu.api.scene import make_scene as jax_make_scene
from hmrt_tpu.io.heightmap import procedural_terrain as jax_procedural_terrain
from hmrt_tpu.kernels.march_body import wavefront_step_l0 as jax_step_l0
from hmrt_tpu.traversal.intersect import INTERSECTORS as JAX_INTERSECTORS
from hmrt_tpu.traversal.march import corner_heights as jax_corner_heights
from hmrt_tpu_torch.api.scene import scene_from_arrays
from hmrt_tpu_torch.bench.configs import BENCH_CONFIGS, bench_scene
from hmrt_tpu_torch.core.pyramid import POS_INF, build_min_pyramid_flat, min_flat_size
from hmrt_tpu_torch.distrib.dryrun import render_sharded_jobs, scene_digest
from hmrt_tpu_torch.distrib.mesh import make_mesh, replicate_scene, spawn
from hmrt_tpu_torch.kernels.compact import (empty_results, init_state, primary_rays,
                                            render_frame_compact)
from hmrt_tpu_torch.kernels.march_pass import (UNBUDGETED, launch_pass, march_pass,
                                               march_pass_reference)
from hmrt_tpu_torch.kernels.ray_sort import force_level0
from hmrt_tpu_torch.traversal.intersect import BIG_T, INTERSECTORS
from hmrt_tpu_torch.traversal.march import (MARGIN_S, MARGIN_TOL, T_TOL, WorkCounter,
                                            below_margins, entry_cell, l0_min_step, l0_step,
                                            ray_box_range, ray_inverses, record_corners,
                                            run_masked, step_geometry)

torch.set_num_threads(2)  # the suite runs several workers at once

N = 65
CIS = ["triangle", "bilinear"]
BUDGETS = [1, 7, 33, UNBUDGETED]
HITS = ("hit", "t_hit", "hx", "hy")


@pytest.fixture(scope="module")
def scene():
    return T.make_scene(T.procedural_terrain(N, seed=3), device="cpu")


def _planes(a):
    return tuple(torch.from_numpy(np.ascontiguousarray(x, np.float32)) for x in a)


def _ray(sc, rays):
    ox, oy, oz, dx, dy, dz = rays
    inv_x, inv_y = ray_inverses(dx, dy)
    _, t1, _ = ray_box_range(ox, oy, dx, dy, float(sc.n - 1))
    return (ox, oy, oz, dx, dy, dz, inv_x, inv_y, t1)


def _entry(sc, rays):
    """The state of each ray at its box entry, at level 0 (where a tail
    that starts from scratch stands), and its ray tuple."""
    ray = _ray(sc, rays)
    t0, _, valid = ray_box_range(ray[0], ray[1], ray[3], ray[4], float(sc.n - 1))
    icx, icy = entry_cell(ray[0], ray[1], ray[3], ray[4], t0, 0, sc.m)
    p = t0.shape[0]
    z = torch.zeros(p, dtype=torch.int32)
    state = ((valid & True).to(torch.int32), torch.where(valid, t0, BIG_T), z, icx, icy)
    return ray, state, empty_results(p, "cpu")


def _dict(state, res):
    alive, t, lvl, icx, icy = state
    hit, t_hit, hx, hy = res
    return dict(alive=alive != 0, t=t, lvl=lvl, icx=icx, icy=icy, hit=hit != 0, t_hit=t_hit,
                hx=hx, hy=hy)


def old_hits(sc, ray, state, res, ci):
    """The old walk, `l0_step` over every cell to the end: (hit, t_hit, hx, hy)."""
    corners = record_corners(sc.heights.reshape(-1), sc.n, sc.m)
    st = run_masked(lambda s: l0_step(ray, s, corners, sc.pyr_flat[-1], m=sc.m,
                                      intersector=INTERSECTORS[ci]),
                    _dict(state, res), UNBUDGETED)
    return st["hit"].to(torch.int32), st["t_hit"], st["hx"], st["hy"]


def new_hits(sc, rays, state, res, ci, budget=UNBUDGETED, counter=None):
    """The new tail (march_pass's plain version, one lane a ray) in passes of
    `budget` steps until every ray has ended: (hit, t_hit, hx, hy)."""
    kw = dict(n=sc.n, m=sc.m, levels=sc.levels, budget=budget, cell_intersect=ci,
              l0_only=True, pyr_min=sc.pyr_min_flat)
    for _ in range(100_000):
        if not state[0].any():
            return res
        state, res = march_pass_reference(rays, state, res, sc.pyr_flat, sc.heights,
                                          counter=counter, **kw)
    raise AssertionError("the tail did not end")


def jax_hits(sc, ray, state, res, ci):
    """JAX's level-0 step iterated op by op (jax.disable_jit) to the end."""
    hf = jnp.asarray(sc.heights.reshape(-1).numpy())
    jray = [jnp.asarray(x.numpy()) for x in ray]
    jst = {k: jnp.asarray(v.numpy().astype(np.int32) if v.dtype == torch.bool else v.numpy())
           for k, v in _dict(state, res).items()}
    with jax.disable_jit():
        while bool(jnp.any(jst["alive"] != 0)):
            jst = jax_step_l0(jst, jst["alive"] != 0, *jray, float(sc.pyr_flat[-1]),
                              lambda s=jst: jax_corner_heights(hf, sc.n, s["icx"], s["icy"]),
                              m=sc.m, intersector=JAX_INTERSECTORS[ci])
    return tuple(np.asarray(jst[k]) for k in HITS)


def assert_same_hits(got, want, ctx=""):
    for name, a, b in zip(HITS, got, want):
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        b = b.numpy() if isinstance(b, torch.Tensor) else b
        np.testing.assert_array_equal(np.asarray(a, b.dtype), b, err_msg=f"{name} {ctx}")


# ---- the min pyramid ------------------------------------------------------

def _numpy_min_pool(h: np.ndarray) -> np.ndarray:
    """Levels >= 1 of the min pyramid of the cells' corner minima, by numpy
    (the cell itself when the grid is one cell)."""
    c = np.minimum(np.minimum(h[:-1, :-1], h[:-1, 1:]), np.minimum(h[1:, :-1], h[1:, 1:]))
    m = 1 << max(c.shape[0] - 1, 0).bit_length()
    lvl = np.full((m, m), np.float32(POS_INF), np.float32)
    lvl[:c.shape[0], :c.shape[0]] = c
    out = []
    while lvl.shape[0] > 1:
        s = lvl.shape[0] // 2
        lvl = lvl.reshape(s, 2, s, 2).min(axis=(1, 3))
        out.append(lvl.reshape(-1))
    return np.concatenate(out) if out else lvl.reshape(-1)


@pytest.mark.parametrize("n", [2, 17, 64, 129, 257])
def test_min_pyramid_equals_numpy_min_pool(n):
    """Scene.pyr_min_flat is the numpy min-pool of the cells' corner
    minima, padded cells never the min, levels >= 1 (the one cell of a 2x2
    map), its top the map's lowest height."""
    terr = T.procedural_terrain(n, seed=3) if n > 2 else np.array([[1, 3], [2, 5]], np.float32)
    sc = T.make_scene(terr, device="cpu")
    got = sc.pyr_min_flat.numpy()
    assert got.shape == (min_flat_size(sc.m),) and sc.pyr_min_flat.dtype == torch.float32
    np.testing.assert_array_equal(got, _numpy_min_pool(np.asarray(terr, np.float32)))
    assert got[-1] == np.float32(terr.min())


def test_scene_from_arrays_carries_min_pyramid():
    """A Scene from the JAX package's arrays builds the same min pyramid as
    make_scene (JAX has none to hand over)."""
    js = jax_make_scene(jax_procedural_terrain(N, seed=3), pack=False)
    light = {f.name: np.asarray(getattr(js.light, f.name)) for f in dataclasses.fields(js.light)}
    ts = scene_from_arrays(np.asarray(js.heights), np.asarray(js.pyr_flat), None, light,
                           n=js.n, m=js.m, levels=js.levels, device="cpu")
    want = build_min_pyramid_flat(torch.from_numpy(np.array(js.heights)))
    assert torch.equal(ts.pyr_min_flat, want)


def test_replicate_scene_carries_min_pyramid_one_rank(scene):
    """A one-rank gloo group: replicate_scene rebuilds the min pyramid on the
    rank, the same bits."""
    with make_mesh(device="cpu", backend="gloo") as mesh:
        got = replicate_scene(scene, mesh)
    assert torch.equal(got.pyr_min_flat, scene.pyr_min_flat)
    assert torch.equal(scene_digest(got), scene_digest(scene))


def test_replicate_scene_carries_min_pyramid_two_ranks(scene):
    """Two gloo ranks: every rank's scene digest, the min pyramid's among
    them, equals the scene rank 0 built."""
    terr = T.procedural_terrain(N, seed=3)
    out = spawn(render_sharded_jobs, 2, args=([dict(source=terr, config=T.RenderConfig())],),
                backend="gloo", devices=["cpu"] * 2, timeout=timedelta(seconds=60),
                join_timeout=60, threads=1)
    want = scene_digest(scene).numpy()
    np.testing.assert_array_equal(out[0]["scene_digests"], np.stack([want, want]))


def test_scene_digest_covers_min_pyramid(scene):
    """One flipped entry of the min pyramid changes the scene's digest."""
    bumped = dataclasses.replace(scene, pyr_min_flat=scene.pyr_min_flat.clone())
    bumped.pyr_min_flat[5] += 1.0
    assert not torch.equal(scene_digest(bumped), scene_digest(scene))


# ---- the margin -----------------------------------------------------------

def test_below_margins(scene):
    """The margins are finite and positive, grow with the bilinear model,
    put the floor under the map's lowest height for a descending ray only,
    and do not exist for "flat"."""
    o, d = random_rays(256, N, seed=2)
    ray = _ray(scene, _planes((o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])))
    gmin, gmax = scene.pyr_min_flat[-1], scene.pyr_flat[-1]
    assert below_margins(ray, gmin, gmax, m=scene.m, cell_intersect="flat") is None
    tri = below_margins(ray, gmin, gmax, m=scene.m, cell_intersect="triangle")
    bil = below_margins(ray, gmin, gmax, m=scene.m, cell_intersect="bilinear")
    for m0, m1, zfloor in (tri, bil):
        assert bool(torch.isfinite(m0).all() and (m0 > 0).all() and (m1 > 0).all())
        down = ray[5] < 0
        assert bool((zfloor[down] < gmin).all() and (zfloor[~down] == -BIG_T).all())
    assert bool((bil[0] >= tri[0]).all() and (bil[1] > tri[1]).all())


# ---- the margin at B3's scale -----------------------------------------------

B3_M = 4096  # B3's map: 4096² samples, heights in [0, 0.12 (n - 1)]
B4_M = 8192  # B4's map: 8192² samples, the same relief per sample


def _window_test(o, d, cx, cy, z, ci, relief, m=B3_M):
    """The f32 test of cell (cx, cy), corners z (z00, z10, z01, z11), as
    the tail's step makes it on an m² map (B3's by default) of heights in
    [0, relief]:
    over the window from the ray's entry into the cell to its exit,
    widened by T_TOL. Returns the hit, the ray's highest point over the
    window as the step computes it (zw), the corners' min (lo) and span,
    the margins (m0, m1) and the world magnitude A of `below_margins`."""
    ox, oy, oz, dx, dy, dz = _planes((*o.T, *d.T))
    inv_x, inv_y = ray_inverses(dx, dy)
    _, t1, _ = ray_box_range(ox, oy, dx, dy, float(m - 1))
    ray = (ox, oy, oz, dx, dy, dz, inv_x, inv_y, t1)
    cx, cy = torch.from_numpy(cx.astype(np.int32)), torch.from_numpy(cy.astype(np.int32))
    ex = (cx + (dx < 0).to(torch.int32)).to(torch.float32)
    ey = (cy + (dy < 0).to(torch.int32)).to(torch.float32)
    t = torch.maximum((ex - ox) * inv_x, (ey - oy) * inv_y)
    t_exit = torch.minimum(step_geometry(ox, oy, dx, dy, cx, cy, torch.zeros_like(cx),
                                         inv_x, inv_y)[0], t1)
    z00, z10, z01, z11 = _planes(z.T)
    hit, _ = INTERSECTORS[ci](ox, oy, oz, dx, dy, dz, cx, cy, z00, z10, z01, z11, t - T_TOL,
                              t_exit + T_TOL)
    lo = torch.minimum(torch.minimum(z00, z10), torch.minimum(z01, z11))
    span = torch.maximum(torch.maximum(z00, z10), torch.maximum(z01, z11)) - lo
    m0, m1, _ = below_margins(ray, torch.tensor(0.0), torch.tensor(relief), m=m,
                              cell_intersect=ci)
    zw = oz + torch.maximum(t * dz, t_exit * dz)
    a = (torch.abs(ox) + torch.abs(oy)) + torch.abs(t1) * (torch.abs(dx) + torch.abs(dy))
    return hit, zw, lo, span, m0, m1, a + float(2 * m + 2)


def _skipped(zw, lo, span, m0, m1):
    """The step's test under the terrain: the ray passes the cell untested."""
    return zw + (m0 + span * m1) < lo


def _aimed_under_corners(p, seed):
    """Rays from B3's camera (bench/configs.py: above the map's near edge,
    at its max height + 0.06 n) aimed just under the lowest corner of
    sloped cells anywhere on the map, by 1e-7 to 1e-2: the rounding at
    B3's world magnitudes decides whether the test meets the cell."""
    rng = np.random.default_rng(seed)
    relief = 0.12 * (B3_M - 1)
    eye = np.array([0.5 * B3_M, -0.25 * B3_M, relief + 0.06 * B3_M])
    cx, cy = rng.integers(200, 3900, p), rng.integers(0, 3000, p)
    span = rng.choice([0.0, 0.05, 0.5, 2.0, 8.0], p)
    z = (rng.uniform(0, 1, (p, 4)) * span[:, None]
         + rng.uniform(0, relief - 10, p)[:, None]).astype(np.float32)
    k = np.argmin(z, 1)
    under = rng.uniform(0, 1, p) * 10.0 ** rng.uniform(-7, -2, p)
    target = np.stack([cx + (k % 2) + rng.uniform(-1e-3, 1e-3, p),
                       cy + (k // 2) + rng.uniform(-1e-3, 1e-3, p),
                       z.min(1).astype(np.float64) - under], -1)
    d = target - eye
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.repeat(eye[None], p, 0), d, cx, cy, z, relief


def _steep_at_the_window_edge(p, seed):
    """Steep rays that meet a flat cell's plane up to 3e-4 before they
    enter the cell, near the far edge of a 4096² map of 64 of relief (so
    that the heights' rounding term stays under the window's slack): the
    f32 containment test takes the point for the cell's, at the bottom of
    the window's T_TOL slack."""
    rng = np.random.default_rng(seed)
    relief = 64.0
    cx, cy = np.full(p, B3_M - 3), rng.integers(100, 4000, p)
    lo = rng.uniform(0, relief, p).astype(np.float32)
    d = np.stack([rng.uniform(0.05, 0.24, p), rng.uniform(-0.05, 0.05, p), -np.ones(p)], -1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    meet = np.stack([cx - rng.uniform(0, 3e-4, p), cy + rng.uniform(0.2, 0.8, p), lo], -1)
    o = meet - rng.uniform(2, 10, p)[:, None] * d
    return o, d, cx, cy, np.repeat(lo[:, None], 4, 1), relief


@pytest.mark.parametrize("family", ["under_corners", "window_edge"])
@pytest.mark.parametrize("ci", CIS)
def test_margin_at_b3_scale(ci, family):
    """The f32 intersectors on rays at B3's world magnitudes (A ~ 1e4) that
    pass just under cells' lowest corners: no hit lies under the margin
    (the step would have skipped it), and the margin is not idle. Aimed
    from B3's camera, hits land below the corner, where only the rounding
    terms keep them: without them (T_TOL |dz| and the containment slack
    alone) the step would lose some. Steep rays at a window's edge reach
    the window's slack: halved, the margin loses triangle hits."""
    o, d, cx, cy, z, relief = (_aimed_under_corners(40_000, 5) if family == "under_corners"
                               else _steep_at_the_window_edge(40_000, 6))
    hit, zw, lo, span, m0, m1, a = _window_test(o, d, cx, cy, z, ci, relief)
    assert float(a.min()) > 8e3
    assert int(hit.sum()) > 1000
    assert not bool((hit & _skipped(zw, lo, span, m0, m1)).any())
    if family == "under_corners":
        assert int((hit & (zw < lo)).sum()) > 100
        bare = _skipped(zw, lo, span, MARGIN_TOL * torch.abs(torch.from_numpy(d[:, 2]).float()),
                        torch.full_like(m1, MARGIN_S))
        assert int((hit & bare).sum()) > 10
    elif ci == "triangle":
        assert int((hit & _skipped(zw, lo, span, 0.5 * m0, 0.5 * m1)).sum()) > 100


def _aimed_from_orbit(p, seed):
    """Rays from the eyes of B4's eight orbit frames (`orbit_flythrough`
    over the 8192² map, its relief 0.12 (n - 1)) aimed just under the
    lowest corner of sloped cells anywhere on the map, by 1e-7 to 1e-2:
    the world magnitudes of B4's tails, A ~ 2e4 to 4e4."""
    from hmrt_tpu_torch.api.flythrough import orbit_flythrough
    rng = np.random.default_rng(seed)
    relief = 0.12 * (B4_M - 1)
    eyes = orbit_flythrough(B4_M, relief, 8, device="cpu").eye.numpy().astype(np.float64)
    eye = eyes[rng.integers(0, 8, p)]
    cx, cy = rng.integers(200, B4_M - 200, p), rng.integers(200, B4_M - 200, p)
    span = rng.choice([0.0, 0.05, 0.5, 2.0, 8.0], p)
    z = (rng.uniform(0, 1, (p, 4)) * span[:, None]
         + rng.uniform(0, relief - 10, p)[:, None]).astype(np.float32)
    k = np.argmin(z, 1)
    under = rng.uniform(0, 1, p) * 10.0 ** rng.uniform(-7, -2, p)
    target = np.stack([cx + (k % 2) + rng.uniform(-1e-3, 1e-3, p),
                       cy + (k // 2) + rng.uniform(-1e-3, 1e-3, p),
                       z.min(1).astype(np.float64) - under], -1)
    d = target - eye
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return eye, d, cx, cy, z, relief


def margin_at_b4_scale(ci, p=40_000, seed=9):
    """The margin at B4's world magnitudes (`_aimed_from_orbit`): the hits,
    the hits below the corner, the hits skipped under the margin (none may
    be) and without the rounding terms, the least A, and the largest share
    of the margin a hit comes within of the corner, (lo - zw) / margin."""
    o, d, cx, cy, z, relief = _aimed_from_orbit(p, seed)
    hit, zw, lo, span, m0, m1, a = _window_test(o, d, cx, cy, z, ci, relief, m=B4_M)
    bare = _skipped(zw, lo, span, MARGIN_TOL * torch.abs(torch.from_numpy(d[:, 2]).float()),
                    torch.full_like(m1, MARGIN_S))
    reach = ((lo - zw) / (m0 + span * m1))[hit]
    return {"hits": int(hit.sum()), "below_corner": int((hit & (zw < lo)).sum()),
            "skipped": int((hit & _skipped(zw, lo, span, m0, m1)).sum()),
            "skipped_bare": int((hit & bare).sum()), "a_min": float(a.min()),
            "reach": float(reach.max())}


@pytest.mark.parametrize("ci", CIS)
def test_margin_at_b4_scale(ci):
    """The f32 intersectors on rays from B4's orbit cameras over its 8192²
    map (A ~ 2e4 to 4e4) that pass just under cells' lowest corners: no hit
    lies under the margin, hits land below the corner, and without the
    rounding terms the step would lose some (`margin_at_b4_scale`)."""
    r = margin_at_b4_scale(ci)
    assert r["a_min"] > 1.6e4
    assert r["hits"] > 1000 and r["below_corner"] > 100
    assert r["skipped"] == 0 and r["reach"] < 1.0
    assert r["skipped_bare"] > 10


# ---- the new tail's hits against the old walk and JAX ----------------------

def _under(p, seed, sc):
    """Rays from inside the terrain and under it: descending, level and
    rising, across the map in any heading."""
    rng = np.random.default_rng(seed)
    h = sc.heights.numpy()
    x, y = rng.uniform(0, N - 1, p), rng.uniform(0, N - 1, p)
    z = h[y.astype(int), x.astype(int)] - rng.uniform(0.0, 6.0, p)
    d = np.stack([rng.uniform(-1, 1, p), rng.uniform(-1, 1, p), rng.uniform(-0.4, 0.25, p)], -1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return _planes((x, y, z, d[:, 0], d[:, 1], d[:, 2]))


def _near_block_minimum(sc, ci, p=192, seed=7):
    """Level rays that pass a level-1..3 block at the height of its min less
    the margin, times 0.5 to 1.5: on either side of the skip's threshold."""
    rng = np.random.default_rng(seed)
    mm = sc.m * sc.m
    out = []
    for i in range(p):
        lvl = int(rng.integers(1, 4))
        side = sc.m >> lvl
        bx, by = (int(v) for v in rng.integers(0, max((N - 1) >> lvl, 1), 2))
        off = (mm - (mm >> (2 * lvl))) * 4 // 3 + by * side + bx
        lo, hi = float(sc.pyr_min_flat[off - mm]), float(sc.pyr_flat[off])
        y = (by + rng.uniform(0.1, 0.9)) * (1 << lvl)
        rays = _planes(([-0.5], [y], [lo], [1.0], [rng.uniform(-0.02, 0.02)],
                        [rng.uniform(-1e-3, 1e-3)]))
        m0, m1, _ = below_margins(_ray(sc, rays), sc.pyr_min_flat[-1], sc.pyr_flat[-1], m=sc.m,
                                  cell_intersect=ci)
        z = lo - float(m0[0] + (hi - lo) * m1[0]) * rng.uniform(0.5, 1.5)
        out.append((-0.5, y, z, 1.0, float(rays[4][0]), float(rays[5][0])))
    a = np.array(out, np.float64)
    a[:, 3:] /= np.linalg.norm(a[:, 3:], axis=1, keepdims=True)
    return _planes(tuple(a.T))


@pytest.mark.parametrize("ci", CIS)
def test_tail_hits_equal_old_walk_and_jax_under_the_terrain(scene, ci):
    """Rays under the terrain (descending, level and rising) and level rays
    at a block's min less the margin, from their entry cells: the new tail
    gives the old walk's and JAX's hit, t_hit, hx, hy, bit for bit, while
    taking fewer steps and cell tests; rising rays hit from below."""
    rays = tuple(torch.cat([a, b]) for a, b in zip(_under(384, 3, scene),
                                                   _near_block_minimum(scene, ci)))
    ray, state, res = _entry(scene, rays)
    work = WorkCounter(scene.pyr_flat.shape[0], scene.n, "cpu", lanes=rays[0].shape[0])
    got = new_hits(scene, rays, state, res, ci, counter=work)
    want = old_hits(scene, ray, state, res, ci)
    assert_same_hits(got, want)
    assert_same_hits(got, jax_hits(scene, ray, state, res, ci))
    old_work = WorkCounter(scene.pyr_flat.shape[0], scene.n, "cpu", lanes=rays[0].shape[0])
    corners = record_corners(scene.heights.reshape(-1), scene.n, scene.m)
    below = below_margins(ray, scene.pyr_min_flat[-1], scene.pyr_flat[-1], m=scene.m,
                          cell_intersect=ci)
    run_masked(lambda s: l0_min_step(ray, s, corners, scene.pyr_flat, scene.pyr_min_flat,
                                     scene.pyr_flat[-1], below, m=scene.m, levels=scene.levels,
                                     intersector=INTERSECTORS[ci], counter=old_work,
                                     hierarchy=False),
               _dict(state, res), UNBUDGETED)
    assert int(work.tests) < int(old_work.tests) and int(work.steps) < int(old_work.steps)
    assert 0 < int(want[0].sum()) < rays[0].shape[0]


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("ci", CIS)
def test_tail_hits_on_b3_camera(ci, budget):
    """The B3 camera (bench/configs.py) over a 129^2 map at 64x36: its rays
    after a 6-step max-mip pass, forced to level 0, through the new tail in
    passes of `budget` steps to the end: the old walk's and JAX's hits, bit
    for bit; the rays that reach the tail include rays under the terrain."""
    cfg = dataclasses.replace(BENCH_CONFIGS["B3"], map_n=129)
    sc, cam, _ = bench_scene(cfg, device="cpu")
    rays = primary_rays(cam, dataclasses.replace(cfg.render, width=64, height=36))
    p = rays[0].shape[0]
    kw = dict(n=sc.n, m=sc.m, levels=sc.levels, cell_intersect=ci)
    st = init_state(rays, None, sc.pyr_flat[-1], n=sc.n, m=sc.m, levels=sc.levels)
    st, res = march_pass_reference(rays, st, empty_results(p, "cpu"), sc.pyr_flat, sc.heights,
                                   budget=6, **kw)
    st = force_level0(rays, st)
    ray = _ray(sc, rays)
    want = old_hits(sc, ray, st, res, ci)
    got = new_hits(sc, rays, st, res, ci, budget=budget)
    assert_same_hits(got, want, f"budget {budget}")
    if budget == UNBUDGETED:
        assert_same_hits(got, jax_hits(sc, ray, st, res, ci))
        live = st[0] != 0
        assert int(live.sum()) > 0 and bool((want[0][live] == 0).any())


#: coordinates on and off the grid's lines, its edges and just outside
_COORD = hs.one_of(hs.integers(0, N - 1).map(float),
                   hs.integers(0, N - 2).map(lambda c: c + 0.5),
                   hs.sampled_from([0.0, float(N - 1), -0.5, N - 0.5, 1e-7, N - 1 - 1e-5]),
                   hs.floats(-2.0, N + 1.0, width=32))
#: direction components: axis-parallel (0, signed zero), below TINY, the
#: diagonal's equal magnitudes (exact tx == ty ties), any
_COMP = hs.one_of(hs.sampled_from([0.0, -0.0, 1e-21, -1e-21, 1.0, -1.0, 0.5, -0.5]),
                  hs.floats(-1.0, 1.0, width=32))


@settings(max_examples=60, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.function_scoped_fixture])
@given(data=hs.data())
def test_tail_hits_special_rays(scene, data):
    """Drawn rays: axis-parallel, components below TINY, exact tx == ty
    ties at block corners, starts on the grid's edges and lines, rays under
    the terrain going down, level or up, and rays from above; from their
    entry cell, with each model and budget, the new tail's hits are the old
    walk's, bit for bit."""
    p = 8
    h = scene.heights.numpy()
    origins, dirs = [], []
    for _ in range(p):
        kind = data.draw(hs.sampled_from(["any", "tie", "edge", "under"]))
        ox, oy = data.draw(_COORD), data.draw(_COORD)
        oz = data.draw(hs.floats(-5.0, 40.0, width=32))
        dx, dy = data.draw(_COMP), data.draw(_COMP)
        dz = data.draw(hs.floats(-0.5, 0.5, width=32))
        if kind == "tie":  # from a block's corner along a diagonal
            k = 1 << data.draw(hs.integers(0, 3))
            ox = float(data.draw(hs.integers(0, (N - 1) // k)) * k)
            oy = float(data.draw(hs.integers(0, (N - 1) // k)) * k)
            s = data.draw(hs.sampled_from([1.0, -1.0]))
            dy = s * dx if dx != 0 else 0.7
            dx = dx if dx != 0 else 0.7
        elif kind == "edge":
            ox = data.draw(hs.sampled_from([0.0, float(N - 1)]))
        elif kind == "under":
            cx, cy = int(min(max(ox, 0), N - 1)), int(min(max(oy, 0), N - 1))
            oz = float(h[cy, cx]) - data.draw(hs.floats(0.0, 8.0, width=32))
        origins.append((ox, oy, oz))
        dirs.append((dx, dy, dz))
    o, d = np.array(origins, np.float64), np.array(dirs, np.float64)
    nrm = np.linalg.norm(d, axis=1, keepdims=True)
    d = np.where(nrm > 0, d / np.where(nrm > 0, nrm, 1.0), d)
    rays = _planes((o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]))
    ray, state, res = _entry(scene, rays)
    ci = data.draw(hs.sampled_from(CIS))
    budget = data.draw(hs.sampled_from(BUDGETS))
    assert_same_hits(new_hits(scene, rays, state, res, ci, budget=budget),
                     old_hits(scene, ray, state, res, ci))


def test_serial_walk_without_hierarchy_is_old_walk_plus_floor(scene):
    """With hierarchy=False the step is `l0_step` plus the floor exit (the
    serial walk the latency probe models): on rays the floor does not end, every plane equals
    the old walk's; the floor ends rays under the map's lowest height."""
    rays = _under(256, 11, scene)
    ray, state, res = _entry(scene, rays)
    corners = record_corners(scene.heights.reshape(-1), scene.n, scene.m)
    below = below_margins(ray, scene.pyr_min_flat[-1], scene.pyr_flat[-1], m=scene.m,
                          cell_intersect="triangle")
    kw = dict(m=scene.m, intersector=INTERSECTORS["triangle"])
    old = run_masked(lambda s: l0_step(ray, s, corners, scene.pyr_flat[-1], **kw),
                     _dict(state, res), UNBUDGETED)
    new = run_masked(lambda s: l0_min_step(ray, s, corners, scene.pyr_flat, scene.pyr_min_flat,
                                           scene.pyr_flat[-1], below, levels=scene.levels,
                                           hierarchy=False, **kw),
                     _dict(state, res), UNBUDGETED)
    floor = ray[2] + new["t"] * ray[5] < below[2]
    assert bool(floor.any()) and bool((~floor & (new["hit"] | ~new["alive"])).any())
    for k in ("alive", "t", "lvl", "icx", "icy", *HITS):
        assert torch.equal(new[k][~floor], old[k][~floor]), k
    for k in HITS:
        assert torch.equal(new[k], old[k]), k


# ---- nothing reads a missed ray's state ------------------------------------

def _scrambling(march):
    """march_pass, then the state planes (t, lvl, icx, icy) of every ray that
    has ended without a hit overwritten with other values."""
    def wrapped(*args, **kw):
        (alive, t, lvl, icx, icy), res = march(*args, **kw)
        missed = (alive == 0) & (res[0] == 0)
        junk = torch.arange(t.shape[0], dtype=torch.int32, device=t.device) % 7 + 3
        return ((alive, torch.where(missed, t * 0.5 + 17.0, t), torch.where(missed, 0, lvl),
                 torch.where(missed, junk, icx), torch.where(missed, -junk, icy)), res)
    return wrapped


@pytest.mark.parametrize("path", ["compact", "band", "tiled"])
def test_missed_rays_state_is_read_by_nothing(path, monkeypatch):
    """A ray that ends as a miss may end anywhere: with the t, lvl, icx and
    icy of every missed ray scrambled after each march pass (primary and
    shadow rounds, the tail, the tiled sweep's sub-scene marches), the
    frame (colour, hit, depth, normal) is the same bits. The readers of a
    march's results (shade_frame, to_frame's depth, shadow_start, the tiled
    sweep, bench/floor.py's counts) read only hit, t_hit, hx and hy."""
    terr = T.procedural_terrain(N, seed=3)
    sc = T.make_scene(terr, device="cpu")
    cam = T.Camera.create(eye=(32.0, -20.0, float(terr.max()) + 6.0),
                          target=(32.0, 32.0, float(terr.mean())), device="cpu")
    cfg = T.RenderConfig(width=48, height=32, shading="phong", shadows=True, aux_buffers=True)
    kw = dict(first_budget=4, round_budget=8)

    def render():
        if path == "compact":
            return render_frame_compact(sc, cam, cfg, l0_tail=True, **kw)
        if path == "band":
            return render_frame_compact(sc, cam, dataclasses.replace(cfg, height=8),
                                        row0=16, full_height=32, l0_tail=True, **kw)
        return T.render_frame_tiled(terr, cam, dataclasses.replace(cfg, backend="compact"),
                                    tile=32, device="cpu")

    want = render()
    monkeypatch.setattr(compact, "launch_pass", _scrambling(launch_pass))
    got = render()
    for f in ("color", "hit", "depth", "normal"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert bool(want.hit.any()) and not bool(want.hit.all())
