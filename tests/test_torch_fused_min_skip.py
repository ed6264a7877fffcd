"""The fused render's march under the terrain, on the CPU.

The fused kernel (`csrc/render_tile.cu`) marches each ray, primary and
shadow, by `traversal/march.py::fused_step`: the max-mip march above the
terrain and the level-0 tail's min walk under it, switching at level 0.
Its plain version, `kernels/march_pass.py::fused_march_reference`, is held
here to the old march, the max-mip march alone
(`march_pass_reference(..., budget=UNBUDGETED)`), which is the witness:
hit, t_hit, hx and hy bit for bit, on frames of every intersector, the B1
camera, the hostile cameras, random rays, row bands, a clip window and
shadow rays; and whole frames (`fused_reference_planes`) to the frame the
old march gives (`fused_witness_planes`), colour included. Under "flat"
nothing is passed under, and every count is the old one. One case is held
to JAX's fused tile kernel in interpret mode.
"""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as hs

import hmrt_tpu_torch as T
from conftest import random_rays
from hmrt_tpu.api.scene import make_scene as jax_make_scene
from hmrt_tpu.config import RenderConfig as JaxRenderConfig
from hmrt_tpu.kernels.raycast import render_frame_pallas
from hmrt_tpu.types import Camera as JaxCamera
from hmrt_tpu_torch.bench.configs import BENCH_CONFIGS, bench_scene
from hmrt_tpu_torch.kernels.compact import empty_results, init_state, shadow_start
from hmrt_tpu_torch.kernels.march_pass import (UNBUDGETED, fused_march_reference,
                                               march_pass_reference)
from hmrt_tpu_torch.kernels.raycast import (fused_planes, fused_reference_planes,
                                            fused_witness_planes, make_params, params_rays,
                                            render_frame_fused_reference)
from hmrt_tpu_torch.kernels.shade_pass import shade_pass_reference
from hmrt_tpu_torch.traversal.intersect import INTERSECTORS
from hmrt_tpu_torch.traversal.march import (WorkCounter, below_margins, fused_step,
                                            maxmip_step, ray_box_range, ray_inverses,
                                            record_corners)
from test_torch_sanitizers import HOSTILE_CAMERAS

torch.set_num_threads(2)  # the suite runs several workers at once

N = 129
CIS = ["triangle", "bilinear", "flat"]


@pytest.fixture(scope="module")
def terr():
    return T.procedural_terrain(N, seed=3)


@pytest.fixture(scope="module")
def scene(terr):
    return T.make_scene(terr, device="cpu")


def _cam(n, terr, **kw):
    """Looking across the map from outside its wall, low enough that many
    rays enter the wall below the surface."""
    return T.Camera.create(eye=(n * 0.5, -n * 0.3, float(terr.max()) + n * 0.08),
                           target=(n * 0.5, n * 0.5, float(terr.mean())), device="cpu", **kw)


def _frame_rays(sc, cam, cfg, row0=None, full_height=None):
    fh = full_height or cfg.height
    params = make_params(sc, cam, cfg, row0, fh)
    rays = params_rays(params, cfg.height, cfg.width, fh)
    state = init_state(rays, None, params[29], n=sc.n, m=sc.m, levels=sc.levels,
                       clip=cfg.clip_box)
    return rays, state


def _march_both(sc, rays, state, ci, clip=None):
    """The new march and the witness on the same rays: (new results,
    witness results, new counter, witness counter)."""
    p = rays[0].shape[0]
    kw = dict(n=sc.n, m=sc.m, levels=sc.levels, cell_intersect=ci, clip=clip)
    works = [WorkCounter(sc.pyr_flat.shape[0], sc.n, "cpu", lanes=p) for _ in range(2)]
    new = fused_march_reference(rays, state, empty_results(p, "cpu"), sc.pyr_flat,
                                sc.heights, sc.pyr_min_flat, counter=works[0], **kw)[1]
    old = march_pass_reference(rays, state, empty_results(p, "cpu"), sc.pyr_flat, sc.heights,
                               budget=UNBUDGETED, counter=works[1], **kw)[1]
    return new, old, works[0], works[1]


def _assert_hits_equal(new, old, ctx=""):
    for name, a, b in zip(("hit", "t_hit", "hx", "hy"), new, old):
        assert torch.equal(a, b), f"{name} differs on {int((a != b).sum())} rays {ctx}"


def _assert_frames_equal(got, want):
    """Planes of fused_planes / fused_witness_planes, all bit for bit."""
    for name, a, b in zip(("colour", "depth", "normal", "hit", "cell"), got, want):
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), f"{name} differs on {int((a != b).sum())} values"


@pytest.mark.parametrize("ci", CIS)
def test_hits_equal_the_old_march_per_intersector(scene, terr, ci):
    """A 96x64 frame's primary rays: hits bit for bit; fewer steps and tests
    than the old march where cells are passed under, every count the old
    one under "flat" (it passes nothing under)."""
    cfg = T.RenderConfig(width=96, height=64, cell_intersect=ci)
    rays, state = _frame_rays(scene, _cam(N, terr), cfg)
    new, old, wn, wo = _march_both(scene, rays, state, ci)
    _assert_hits_equal(new, old)
    assert 0 < int(old[0].sum()) < rays[0].shape[0]
    if ci == "flat":
        assert torch.equal(wn.lane_steps, wo.lane_steps)
        assert torch.equal(wn.lane_tests, wo.lane_tests)
    else:
        assert int(wn.steps) * 3 < int(wo.steps) and int(wn.tests) * 10 < int(wo.tests)


def test_b1_camera_at_a_small_size():
    """B1's map and camera at 128x128: the frame equals the old march's in
    every plane, colour included, and the march takes a fraction of the
    old steps (B1 at full size: 25,414,051 -> 2,817,954, PERF.md)."""
    sc, cam, _ = bench_scene(BENCH_CONFIGS["B1"], device="cpu")
    cfg = dataclasses.replace(BENCH_CONFIGS["B1"].render, width=128, height=128,
                              aux_buffers=True)
    works = [WorkCounter(sc.pyr_flat.shape[0], sc.n, "cpu", lanes=128 * 128)
             for _ in range(2)]
    got = fused_reference_planes(sc, cam, cfg, counter=works[0])
    want = fused_reference_planes(sc, cam, cfg, counter=works[1], witness=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert 0.05 < float(want[3].float().mean()) < 0.95
    assert int(works[0].steps) * 4 < int(works[1].steps)


@pytest.mark.parametrize("name", list(HOSTILE_CAMERAS))
def test_hostile_cameras(name):
    """The four hostile cameras of tests/test_sanitizers.py on the 64^2
    scene, with Phong, shadows and aux buffers: the frame equals the old
    march's in every plane."""
    sc = T.make_scene(T.procedural_terrain(64, seed=3), device="cpu")
    eye, target = HOSTILE_CAMERAS[name]
    cam = T.Camera.create(eye=eye, target=target, device="cpu")
    cfg = T.RenderConfig(width=16, height=16, shading="phong", shadows=True, aux_buffers=True)
    _assert_frames_equal(fused_planes(sc, cam, cfg, cells=True),
                         fused_witness_planes(sc, cam, cfg))


def _wall_rays(p, terr, seed):
    """Rays from outside the map's wall at heights between the map's lowest
    and its mean, nearly level, into the box: most enter the wall below the
    surface."""
    rng = np.random.default_rng(seed)
    side = rng.integers(0, 4, p)
    u = rng.uniform(0.0, N - 1.0, p)
    ox = np.where(side == 0, -3.0, np.where(side == 1, N + 2.0, u))
    oy = np.where(side == 2, -3.0, np.where(side == 3, N + 2.0, u))
    oz = rng.uniform(float(terr.min()), float(terr.mean()), p)
    tx, ty = rng.uniform(0.0, N - 1.0, p), rng.uniform(0.0, N - 1.0, p)
    d = np.stack([tx - ox, ty - oy, rng.uniform(-0.08, 0.08, p) * N], -1)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return np.stack([ox, oy, oz], -1), d


@settings(max_examples=12, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(seed=hs.integers(0, 2**31 - 1), kind=hs.sampled_from(["mixed", "axis", "wall"]),
       ci=hs.sampled_from(CIS))
def test_random_rays(scene, terr, seed, kind, ci):
    """Random rays from around and above the box (conftest.random_rays) and
    into the map's wall below the surface, marched from the pyramid top:
    hits bit for bit."""
    o, d = _wall_rays(256, terr, seed) if kind == "wall" else random_rays(256, N, seed=seed,
                                                                           kind=kind)
    rays = tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                 for a in (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]))
    state = init_state(rays, None, scene.pyr_flat[-1], n=scene.n, m=scene.m,
                       levels=scene.levels)
    new, old, _, _ = _march_both(scene, rays, state, ci)
    _assert_hits_equal(new, old, f"(seed {seed}, {kind}, {ci})")


@pytest.mark.parametrize("row0", [0, 24, 40])
def test_row_bands(scene, terr, row0):
    """16-row bands of a 64-row screen: each equals the old march's band."""
    cfg = T.RenderConfig(width=64, height=16, shading="phong", shadows=True, aux_buffers=True)
    _assert_frames_equal(fused_planes(scene, _cam(N, terr), cfg, row0, 64, cells=True),
                         fused_witness_planes(scene, _cam(N, terr), cfg, row0, 64))


@pytest.mark.parametrize("ci", ["triangle", "bilinear"])
def test_clip_window(scene, terr, ci):
    """Under a clip window (a tile's cells): the rays leave the window, not
    the map; hits bit for bit, and the frame equal to the old march's."""
    cfg = T.RenderConfig(width=64, height=48, cell_intersect=ci, clip_box=(20.0, 100.0),
                         shadows=True, aux_buffers=True)
    cam = _cam(N, terr)
    rays, state = _frame_rays(scene, cam, cfg)
    new, old, _, _ = _march_both(scene, rays, state, ci, clip=cfg.clip_box)
    _assert_hits_equal(new, old)
    assert int(old[0].sum()) > 0
    _assert_frames_equal(fused_planes(scene, cam, cfg, cells=True),
                         fused_witness_planes(scene, cam, cfg))


@pytest.mark.parametrize("ci", ["triangle", "bilinear"])
def test_shadow_rays(terr, ci):
    """Shadow rays toward a low sun from a frame's hits, started at level 0
    in the hit cells as the kernel starts them: hits bit for bit."""
    sc = T.make_scene(terr, light=T.Light.create(sun_dir=(0.8, 0.3, 0.2), device="cpu"),
                      device="cpu")
    cfg = T.RenderConfig(width=96, height=64, cell_intersect=ci)
    rays, state = _frame_rays(sc, _cam(N, terr), cfg)
    hit_i, t_hit, hx, hy = _march_both(sc, rays, state, ci)[1]
    hit = hit_i != 0
    t = torch.where(hit, t_hit, 0.0)
    points = tuple(rays[k] + t * rays[3 + k] for k in range(3))
    fx = torch.clamp(points[0] - hx.to(torch.float32), 0.0, 1.0)
    fy = torch.clamp(points[1] - hy.to(torch.float32), 0.0, 1.0)
    normal = shade_pass_reference(hit_i, hx, hy, fx, fy, sc.shade_rec, None)[:3]
    srays, sstate = shadow_start(points, normal, hit, hx, hy, sc)
    new, old, _, _ = _march_both(sc, srays, sstate, ci)
    _assert_hits_equal(new, old)
    assert 0 < int(old[0].sum()) < int(hit.sum())


def test_a_ray_of_the_min_walk_returns_to_maxmip(scene, terr):
    """A ray of the min walk that stands at level 0 in a cell it clears
    returns to the max-mip march there: its next step is `maxmip_step`'s
    (the skip, ascending the max pyramid by the crossed boundary), and it
    goes on as the max-mip march, to the same hits. (A ray under the
    surface cannot rise above a cell without crossing the surface, whose
    test ends it, so on a heightfield no frame reaches this state by
    itself; the rays are put there: above the terrain, in the min walk.)"""
    sc = scene
    p = 64
    rng = np.random.default_rng(5)
    top = float(terr.max()) + 1.0
    ox = torch.from_numpy(rng.uniform(4.0, N - 5.0, p).astype(np.float32))
    oy = torch.from_numpy(rng.uniform(4.0, N - 5.0, p).astype(np.float32))
    oz = torch.full((p,), top, dtype=torch.float32)
    ang = torch.from_numpy(rng.uniform(0.0, 2 * np.pi, p).astype(np.float32))
    dz = torch.full((p,), -0.2, dtype=torch.float32)
    dx, dy = torch.cos(ang) * 0.9798, torch.sin(ang) * 0.9798
    rays = (ox, oy, oz, dx, dy, dz)
    inv_x, inv_y = ray_inverses(dx, dy)
    _, t1, _ = ray_box_range(ox, oy, dx, dy, float(sc.n - 1))
    ray = (*rays, inv_x, inv_y, t1)
    icx = torch.floor(ox).to(torch.int32)
    icy = torch.floor(oy).to(torch.int32)
    z = torch.zeros(p, dtype=torch.int32)
    st = dict(t=torch.zeros(p), lvl=z, icx=icx, icy=icy, alive=torch.ones(p, dtype=torch.bool),
              hit=torch.zeros(p, dtype=torch.bool), t_hit=torch.full((p,), 3.0e38), hx=z, hy=z,
              under=torch.ones(p, dtype=torch.bool))
    heights = sc.heights.reshape(-1)
    kw = dict(n=sc.n, m=sc.m, levels=sc.levels, intersector=INTERSECTORS["triangle"])
    below = below_margins(ray, sc.pyr_min_flat[-1], sc.pyr_flat[-1], m=sc.m,
                          cell_intersect="triangle")
    nxt = fused_step(ray, st, record_corners(heights, sc.n, sc.m), sc.pyr_flat, heights,
                     sc.pyr_min_flat, sc.pyr_flat[-1], below, **kw)
    want = maxmip_step(ray, st, sc.pyr_flat, heights, sc.pyr_flat[-1], **kw)
    assert not bool(nxt["under"].any())
    for k in want:
        assert torch.equal(nxt[k], want[k]), k
    assert bool((nxt["lvl"] > 0).any())  # an aligned boundary: the ray ascends
    # and from there the march's hits are the max-mip march's
    state = (nxt["alive"].to(torch.int32), nxt["t"], nxt["lvl"], nxt["icx"], nxt["icy"])
    new, old, _, _ = _march_both(sc, rays, state, "triangle")
    _assert_hits_equal(new, old)
    assert int(old[0].sum()) > 0


def test_under_a_ridge_the_walk_passes_blocks(scene, terr):
    """Rays that enter the map's wall below the surface take the min walk:
    the frame's counts show steps that pass cells untested (a fraction of
    the old tests), and the march's hits are the old ones."""
    cam = T.Camera.create(eye=(N * 0.5, -N * 0.5, float(terr.min()) + 2.0),
                          target=(N * 0.5, N * 0.5, float(terr.min()) + 1.0), device="cpu")
    cfg = T.RenderConfig(width=32, height=32)
    rays, state = _frame_rays(scene, cam, cfg)
    new, old, wn, wo = _march_both(scene, rays, state, "triangle")
    _assert_hits_equal(new, old)
    assert int(wn.tests) * 20 < int(wo.tests)


def test_against_jax_fused_kernel():
    """The plain version with its min walk against JAX's fused tile kernel in
    interpret mode, on a camera whose low rays enter the map's wall under
    the terrain: hit mask equal, colour < 5e-5, depth within 1e-4."""
    terr = T.procedural_terrain(65, seed=3)
    eye, target = (32.0, -30.0, float(terr.mean())), (32.0, 32.0, float(terr.mean()) - 4.0)
    cfg = dict(width=64, height=16, shading="phong", shadows=True, aux_buffers=True)
    want = render_frame_pallas(jax_make_scene(terr), jax_make_scene(terr).packed,
                               JaxCamera.create(eye=eye, target=target),
                               JaxRenderConfig(**cfg), interpret=True)
    sc = T.make_scene(terr, device="cpu")
    got = render_frame_fused_reference(sc, T.Camera.create(eye=eye, target=target,
                                                           device="cpu"), T.RenderConfig(**cfg))
    hit = np.asarray(want.hit)
    assert 0.0 < hit.mean() < 1.0
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    assert np.abs(got.color.numpy() - np.asarray(want.color)).max() < 5e-5
    np.testing.assert_allclose(got.depth.numpy()[hit], np.asarray(want.depth)[hit],
                               rtol=1e-5, atol=1e-4)
