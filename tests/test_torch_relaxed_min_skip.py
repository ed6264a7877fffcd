"""The relaxed level-0 tail under the terrain, on the CPU.

The port's relaxed tail (`traversal/march.py::l0_min_step_relaxed`, the
walk of the CUDA kernel's relaxed instance, `march_common.cuh::
relaxed_steps`) samples and walks brackets where the old relaxed walk
(`l0_step_relaxed`) does, but passes a ray under whole blocks of the min
pyramid and ends a descending ray under the map's lowest height. These
tests hold its hits (hit, t_hit, hx, hy) bit for bit to the old relaxed
walk and to JAX's `march_body.py::wavefront_step_l0_relaxed` evaluated op
by op, on the rays where a shortcut could move a hit: under the terrain,
at a block's min less the margin, drawn ties and axes, the B3 camera, a
stride that lands under the floor with a bracket behind it, a block whose
last cell is a corner sliver, rays rising out from under a block; and they
show that nothing reads the state of a relaxed ray that ended as a miss.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as hs

import hmrt_tpu_torch as T
import hmrt_tpu_torch.kernels.compact as compact
import hmrt_tpu_torch.traversal.march as march
from hmrt_tpu.kernels.march_body import wavefront_step_l0_relaxed as jax_step_relaxed
from hmrt_tpu.traversal.intersect import (INTERSECTORS as JAX_INTERSECTORS,
                                          SURFACES as JAX_SURFACES)
from hmrt_tpu.traversal.march import corner_heights as jax_corner_heights
from hmrt_tpu_torch.bench.configs import BENCH_CONFIGS, bench_scene
from hmrt_tpu_torch.kernels.compact import (empty_results, init_state, primary_rays,
                                            render_frame_compact)
from hmrt_tpu_torch.kernels.march_pass import (UNBUDGETED, launch_pass, march_pass,
                                               march_pass_reference)
from hmrt_tpu_torch.kernels.ray_sort import force_level0
from hmrt_tpu_torch.traversal.intersect import INTERSECTORS, SURFACES
from hmrt_tpu_torch.traversal.march import (EPS_EXIT, T_TOL, WorkCounter, below_margins,
                                            l0_min_step_relaxed, l0_step_relaxed,
                                            record_corners, relaxed_planes, run_masked)
from test_torch_min_skip import (HITS, N, _COMP, _COORD, _dict, _entry, _near_block_minimum,
                                 _planes, _ray, _scrambling, _under, assert_same_hits)

torch.set_num_threads(2)  # the suite runs several workers at once

CIS = ["triangle", "bilinear", "flat"]
STRIDES = [4, 8, 16]
BUDGETS = [1, 7, 33, UNBUDGETED]


@pytest.fixture(scope="module")
def scene():
    return T.make_scene(T.procedural_terrain(N, seed=3), device="cpu")


def _start(state, res):
    st = _dict(state, res)
    st.update(relaxed_planes(st["t"]))
    return st


def old_relaxed(sc, ray, state, res, ci, stride, counter=None):
    """The old relaxed walk, `l0_step_relaxed`, to the end: its state dict."""
    corners = record_corners(sc.heights.reshape(-1), sc.n, sc.m)
    return run_masked(lambda s: l0_step_relaxed(ray, s, corners, sc.pyr_flat[-1], m=sc.m,
                                                intersector=INTERSECTORS[ci],
                                                surface=SURFACES[ci], stride=stride,
                                                counter=counter),
                      _start(state, res), UNBUDGETED)


def new_relaxed(sc, ray, state, res, ci, stride, budget=UNBUDGETED, counter=None):
    """The new relaxed walk, `l0_min_step_relaxed`, in passes of `budget`
    steps to the end, every plane (the relaxed ones and lvl too) carried
    from one pass to the next, as the kernel carries them from one chunk
    of steps to the next: its state dict."""
    corners = record_corners(sc.heights.reshape(-1), sc.n, sc.m)
    below = below_margins(ray, sc.pyr_min_flat[-1], sc.pyr_flat[-1], m=sc.m, cell_intersect=ci)
    st = _start(state, res)
    for _ in range(100_000):
        if not st["alive"].any():
            return st
        st = run_masked(lambda s: l0_min_step_relaxed(
            ray, s, corners, sc.pyr_flat, sc.pyr_min_flat, sc.pyr_flat[-1], below, m=sc.m,
            levels=sc.levels, intersector=INTERSECTORS[ci], surface=SURFACES[ci],
            stride=stride, counter=counter), st, budget)
    raise AssertionError("the relaxed tail did not end")


def jax_relaxed(sc, ray, state, res, ci, stride):
    """JAX's relaxed step iterated op by op (jax.disable_jit) to the end:
    (hit, t_hit, hx, hy)."""
    hf = jnp.asarray(sc.heights.reshape(-1).numpy())
    jray = [jnp.asarray(x.numpy()) for x in ray]
    jst = {k: jnp.asarray(v.numpy().astype(np.int32) if v.dtype == torch.bool else v.numpy())
           for k, v in _start(state, res).items()}
    with jax.disable_jit():
        while bool(jnp.any(jst["alive"] != 0)):
            jst = jax_step_relaxed(jst, jst["alive"] != 0, *jray, float(sc.pyr_flat[-1]),
                                   lambda s=jst: jax_corner_heights(hf, sc.n, s["icx"], s["icy"]),
                                   m=sc.m, intersector=JAX_INTERSECTORS[ci],
                                   surface=JAX_SURFACES[ci], stride=stride)
    return tuple(np.asarray(jst[k]) for k in HITS)


def hits(st):
    return tuple(st[k] for k in HITS)


def assert_jax_hits(got, want, ci):
    """hit, hx and hy equal to JAX's op by op; t_hit bit for bit, and for
    "bilinear" within 2 ulps, the standing bar of its root solve against
    JAX's (ROADMAP.md section 3; tests/test_torch_march.py)."""
    if ci != "bilinear":
        return assert_same_hits(got, want)
    assert_same_hits(got[:1] + got[2:], want[:1] + want[2:])
    a = got[1].numpy().view(np.int32).astype(np.int64)
    b = want[1].view(np.int32).astype(np.int64)
    assert int(np.abs(a - b).max()) <= 2, "t_hit more than 2 ulps from JAX's"


def _grazing(sc, p=128, seed=0):
    """Near-horizontal rays from just outside the y=0 edge, 0.3-1.1 of the
    terrain's height up: the rays that stride above the terrain."""
    rng = np.random.default_rng(seed)
    hmax = float(sc.heights.max())
    o = np.stack([rng.uniform(0, N - 1, p), np.full(p, -0.5),
                  rng.uniform(0.3 * hmax, 1.1 * hmax, p)], -1)
    d = np.stack([rng.uniform(-0.3, 0.3, p), np.ones(p), rng.uniform(-0.05, 0.02, p)], -1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return _planes((*o.T, *d.T))


def _mixed(sc, ci):
    """Rays under the terrain (descending, level, rising), level rays at a
    block's min less the margin (the triangle margin for "flat", which has
    none), and grazing rays from above."""
    parts = (_under(160, 3, sc), _near_block_minimum(sc, "triangle" if ci == "flat" else ci,
                                                     p=64), _grazing(sc, 96, 1))
    return tuple(torch.cat(x) for x in zip(*parts))


# ---- the new walk against the old walk and JAX -----------------------------

@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("stride", STRIDES)
@pytest.mark.parametrize("ci", CIS)
def test_relaxed_hits_equal_old_walk(scene, ci, stride, budget):
    """Mixed rays from their entry cells, in passes of `budget` steps: the
    new relaxed walk gives the old relaxed walk's hit, t_hit, hx, hy bit for
    bit, with fewer steps and cell tests where the model has a margin; for
    "flat" (no margin) it is the old walk in every plane and count."""
    rays = _mixed(scene, ci)
    ray, state, res = _entry(scene, rays)
    p = rays[0].shape[0]
    new_w = WorkCounter(scene.pyr_flat.shape[0], scene.n, "cpu", lanes=p)
    old_w = WorkCounter(scene.pyr_flat.shape[0], scene.n, "cpu", lanes=p)
    got = new_relaxed(scene, ray, state, res, ci, stride, budget, counter=new_w)
    want = old_relaxed(scene, ray, state, res, ci, stride, counter=old_w)
    assert_same_hits(hits(got), hits(want), f"stride {stride} budget {budget}")
    assert 0 < int(want["hit"].sum()) < p
    if ci == "flat":
        for k in ("alive", "t", "lvl", "icx", "icy", "rmode", "tprev", "wend"):
            assert torch.equal(got[k], want[k]), k
        assert torch.equal(new_w.lane_steps, old_w.lane_steps)
        assert torch.equal(new_w.lane_tests, old_w.lane_tests)
    else:
        assert int(new_w.steps) < 0.6 * int(old_w.steps)
        assert int(new_w.tests) < 0.2 * int(old_w.tests)


@pytest.mark.parametrize("ci", CIS)
def test_relaxed_hits_equal_jax_op_by_op(scene, ci):
    """The same mixed rays at stride 8: the new walk's hits are JAX's relaxed
    step's, evaluated op by op (`assert_jax_hits`)."""
    rays = _mixed(scene, ci)
    ray, state, res = _entry(scene, rays)
    assert_jax_hits(hits(new_relaxed(scene, ray, state, res, ci, 8)),
                    jax_relaxed(scene, ray, state, res, ci, 8), ci)


@pytest.mark.parametrize("stride", STRIDES)
@pytest.mark.parametrize("ci", CIS)
def test_relaxed_hits_on_b3_camera(ci, stride):
    """The B3 camera (bench/configs.py) over a 129^2 map at 64x36: its rays
    after a 6-step max-mip pass, forced to level 0, through the relaxed
    tail: the old relaxed walk's hits, bit for bit, and at stride 4 JAX's
    op by op (`assert_jax_hits`); the rays that reach the tail include rays under the terrain."""
    cfg = dataclasses.replace(BENCH_CONFIGS["B3"], map_n=129)
    sc, cam, _ = bench_scene(cfg, device="cpu")
    rays = primary_rays(cam, dataclasses.replace(cfg.render, width=64, height=36))
    p = rays[0].shape[0]
    st = init_state(rays, None, sc.pyr_flat[-1], n=sc.n, m=sc.m, levels=sc.levels)
    st, res = march_pass_reference(rays, st, empty_results(p, "cpu"), sc.pyr_flat, sc.heights,
                                   n=sc.n, m=sc.m, levels=sc.levels, cell_intersect=ci, budget=6)
    st = force_level0(rays, st)
    ray = _ray(sc, rays)
    got = hits(new_relaxed(sc, ray, st, res, ci, stride))
    want = hits(old_relaxed(sc, ray, st, res, ci, stride))
    assert_same_hits(got, want)
    if stride == 4:
        assert_jax_hits(got, jax_relaxed(sc, ray, st, res, ci, stride), ci)
    live = st[0] != 0
    assert int(live.sum()) > 0 and bool((want[0][live] == 0).any())


@settings(max_examples=60, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.function_scoped_fixture])
@given(data=hs.data())
def test_relaxed_hits_special_rays(scene, data):
    """Drawn rays: axis-parallel, components below TINY, exact tx == ty
    ties from block corners, starts on the grid's edges and lines, rays
    under the terrain going down, level or up, and rays from above; from
    their entry cell, with each model, stride and budget, the new relaxed
    walk's hits are the old relaxed walk's, bit for bit."""
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
    ray, state, res = _entry(scene, _planes((*o.T, *d.T)))
    ci = data.draw(hs.sampled_from(CIS))
    stride = data.draw(hs.sampled_from(STRIDES))
    budget = data.draw(hs.sampled_from(BUDGETS))
    assert_same_hits(hits(new_relaxed(scene, ray, state, res, ci, stride, budget)),
                     hits(old_relaxed(scene, ray, state, res, ci, stride)))


# ---- where a shortcut could move a hit -------------------------------------

def _pending_bracket(sc, stride, p=256, seed=0):
    """Steep descending rays from just above the highest corner of their
    first cell, whose first stride lands under the map's lowest height:
    the surface is crossed inside that stride's bracket."""
    rng = np.random.default_rng(seed + stride)
    h = sc.heights.numpy()
    gmin = float(h.min())
    x, y = rng.uniform(8, 40, p), rng.uniform(8, 56, p)
    ix, iy = x.astype(int), y.astype(int)
    z = np.maximum.reduce([h[iy + a, ix + b] for a in (0, 1) for b in (0, 1)]) \
        + rng.uniform(0.05, 1.0, p)
    drop = (z - gmin) + rng.uniform(1.0, 3.0, p)
    d = np.stack([np.ones(p), rng.uniform(-0.2, 0.2, p),
                  -drop / (stride * rng.uniform(0.6, 0.95, p))], -1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return _planes((x, y, z, *d.T))


@pytest.mark.parametrize("stride", STRIDES)
@pytest.mark.parametrize("ci", ["triangle", "bilinear"])
def test_relaxed_floor_waits_for_the_pending_bracket(scene, ci, stride):
    """A ray samples above the surface and its stride lands under the floor:
    the bracket behind it holds its hit, which the floor exit must not take
    away (it ends a ray only in the walk, or at a sample below with an
    empty bracket). Every such ray hits, as in the old walk, bit for bit."""
    rays = _pending_bracket(scene, stride)
    ray, state, res = _entry(scene, rays)
    ox, oy, oz, dx, dy, dz, inv_x, inv_y, t1 = ray
    t = state[1]
    ts = torch.maximum(t, torch.minimum(t + stride * torch.minimum(inv_x.abs(), inv_y.abs()),
                                        t1 - EPS_EXIT))
    zfloor = below_margins(ray, scene.pyr_min_flat[-1], scene.pyr_flat[-1], m=scene.m,
                           cell_intersect=ci)[2]
    assert bool((oz + ts * dz < zfloor).all())  # the first stride lands under the floor
    got = new_relaxed(scene, ray, state, res, ci, stride)
    want = old_relaxed(scene, ray, state, res, ci, stride)
    assert_same_hits(hits(got), hits(want))
    assert bool(want["hit"].all())


def _corner_slivers(sc, p=256, seed=4):
    """Level and slowly rising rays under the terrain that cross a block's
    top edge within 5e-4 cells of an interior cell line: the block's last
    cell along the ray spans less than T_TOL of t."""
    rng = np.random.default_rng(seed)
    h = sc.heights.numpy()
    out = []
    for _ in range(p):
        k = int(rng.integers(1, 4))
        side = 1 << k
        bx, by = (int(v) for v in rng.integers(0, (N - 1) // side - 1, 2))
        px = bx * side + int(rng.integers(1, side)) + rng.uniform(1e-6, 5e-4)
        py = (by + 1) * side
        theta = rng.uniform(0.35, 1.2)
        d = np.array([np.cos(theta), np.sin(theta), rng.uniform(0.0, 0.02)])
        lo = float(h[by * side:(by + 1) * side + 1, bx * side:(bx + 1) * side + 1].min())
        s = rng.uniform(1.0, 1.5) * side
        out.append((px - s * d[0], py - s * d[1], lo - rng.uniform(0.5, 2.0), *d))
    a = np.array(out, np.float64)
    a[:, 3:] /= np.linalg.norm(a[:, 3:], axis=1, keepdims=True)
    return _planes(tuple(a.T))


@pytest.mark.parametrize("ci", ["triangle", "bilinear"])
def test_relaxed_block_with_a_sliver_last_cell(scene, ci, monkeypatch):
    """Rays under the terrain that leave a block through a corner sliver,
    its last cell shorter than T_TOL in t (the case occurs: counted through
    `last_entry`): the block's exit is not where the old walk samples next,
    so the walk passes the block only where the old walk would walk all of
    it, and descends elsewhere; the hits are the old relaxed walk's, bit
    for bit, and JAX's op by op (`assert_jax_hits`)."""
    slivers = []

    def spy(ray, t, icx, icy, cx, cy, axis_x):
        t_l = march._last_entry(ray, t, icx, icy, cx, cy, axis_x)
        ox, oy, _, dx, dy, _, inv_x, inv_y, _ = ray
        b = torch.where(axis_x, cx + (dx < 0).to(torch.int32), cy + (dy < 0).to(torch.int32))
        t_b = torch.where(axis_x, (b.to(torch.float32) - ox) * inv_x,
                          (b.to(torch.float32) - oy) * inv_y)
        slivers.append(int((t_b <= t_l + T_TOL).sum()))
        return t_l

    monkeypatch.setattr(march, "_last_entry", march.last_entry, raising=False)
    monkeypatch.setattr(march, "last_entry", spy)
    ray, state, res = _entry(scene, _corner_slivers(scene))
    got = hits(new_relaxed(scene, ray, state, res, ci, 8))
    assert sum(slivers) > 10
    assert_same_hits(got, hits(old_relaxed(scene, ray, state, res, ci, 8)))
    assert_jax_hits(got, jax_relaxed(scene, ray, state, res, ci, 8), ci)


def _rising_out(sc, ci, p=192, seed=8):
    """Rays just under a block's min less the margin that rise out of the
    terrain within the two cells past the block, where the terrain is
    lower: the walk passes the block, then meets the surface from below."""
    rng = np.random.default_rng(seed)
    h = sc.heights.numpy()
    mm = sc.m * sc.m
    out = []
    while len(out) < p:
        k = int(rng.integers(1, 4))
        side = 1 << k
        bx, by = (int(v) for v in rng.integers(0, (N - 1) // side - 1, 2))
        off = (mm - (mm >> (2 * k))) * 4 // 3 + by * sc.m // side + bx
        lo = float(sc.pyr_min_flat[off - mm])
        x1 = (bx + 1) * side
        past = float(h[by * side:(by + 1) * side + 1, x1 + 1:x1 + 3].min())
        if past > lo - 0.5:
            continue
        y = (by + rng.uniform(0.2, 0.8)) * side
        rise = (lo - past) * rng.uniform(0.6, 1.2) / (side + 2)
        d = np.array([1.0, rng.uniform(-0.05, 0.05), rise])
        d /= np.linalg.norm(d)
        rays = _planes(([bx * side - 0.5], [y], [lo], *([v] for v in d)))
        m0, m1, _ = below_margins(_ray(sc, rays), sc.pyr_min_flat[-1], sc.pyr_flat[-1], m=sc.m,
                                  cell_intersect=ci)
        z = lo - float(m0[0]) * 2.0 - (side + 0.5) * d[2] / d[0] - rng.uniform(0.0, 0.3)
        out.append((bx * side - 0.5, y, z, *d))
    return _planes(tuple(np.array(out, np.float64).T))


@pytest.mark.parametrize("ci", ["triangle", "bilinear"])
def test_relaxed_hits_rays_rising_out_from_under_a_block(scene, ci):
    """Rays that pass under a block and come out of the terrain into the
    lower cells past it: the hit from below, where they come out, is the
    old relaxed walk's, bit for bit, at every stride; most of them hit."""
    ray, state, res = _entry(scene, _rising_out(scene, ci))
    for stride in STRIDES:
        want = hits(old_relaxed(scene, ray, state, res, ci, stride))
        assert_same_hits(hits(new_relaxed(scene, ray, state, res, ci, stride)), want)
        assert int(want[0].sum()) > 0.5 * ray[0].shape[0]


# ---- the wrapper, and what reads a missed ray -------------------------------

def test_march_pass_relaxed_on_cpu_counts_and_equals_plain(scene):
    """march_pass(relax=k) on CPU tensors runs the plain relaxed tail, with
    or without the min pyramid handed over, and counts as the kernel's
    counting instance does: every step, and the exact cell tests; far fewer
    than the old relaxed walk's on rays under the terrain."""
    rays = _under(256, 5, scene)
    state = force_level0(rays, init_state(rays, None, scene.pyr_flat[-1], n=scene.n,
                                          m=scene.m, levels=scene.levels))
    p = rays[0].shape[0]
    kw = dict(n=scene.n, m=scene.m, levels=scene.levels, budget=UNBUDGETED, l0_only=True)
    ray = _ray(scene, rays)
    for k in STRIDES:
        counts = torch.empty((2, p), dtype=torch.int32)
        got = march_pass(rays, state, empty_results(p, "cpu"), scene.pyr_flat, scene.heights,
                         scene.corners, counts=counts, relax=k, pyr_min=scene.pyr_min_flat, **kw)
        work = WorkCounter(scene.pyr_flat.shape[0], scene.n, "cpu", lanes=p)
        want = march_pass_reference(rays, state, empty_results(p, "cpu"), scene.pyr_flat,
                                    scene.heights, counter=work, relax=k, **kw)
        for a, b in zip(got[0] + got[1], want[0] + want[1]):
            assert torch.equal(a, b)
        assert torch.equal(counts[0], work.lane_steps)
        assert torch.equal(counts[1], work.lane_tests)
        old = WorkCounter(scene.pyr_flat.shape[0], scene.n, "cpu", lanes=p)
        old_st = old_relaxed(scene, ray, state, empty_results(p, "cpu"), "triangle", k,
                             counter=old)
        assert_same_hits(got[1], hits(old_st))
        assert int(counts[0].sum()) < 0.5 * int(old.steps)
        assert int(counts[1].sum()) < 0.1 * int(old.tests)


@pytest.mark.parametrize("path", ["compact", "band"])
def test_relaxed_missed_rays_state_is_read_by_nothing(path, monkeypatch):
    """A relaxed ray that ends as a miss may end anywhere: with the t, lvl,
    icx and icy of every missed ray scrambled after each march pass
    (primary and shadow rounds, the relaxed tails), the relaxed frame
    (colour, hit, depth, normal) is the same bits."""
    terr = T.procedural_terrain(N, seed=3)
    sc = T.make_scene(terr, device="cpu")
    cam = T.Camera.create(eye=(32.0, -20.0, float(terr.max()) + 6.0),
                          target=(32.0, 32.0, float(terr.mean())), device="cpu")
    cfg = T.RenderConfig(width=48, height=32, shading="phong", shadows=True, aux_buffers=True)
    kw = dict(first_budget=4, round_budget=8, l0_tail=True, relax=8)

    def render():
        if path == "compact":
            return render_frame_compact(sc, cam, cfg, **kw)
        return render_frame_compact(sc, cam, dataclasses.replace(cfg, height=8), row0=16,
                                    full_height=32, **kw)

    want = render()
    monkeypatch.setattr(compact, "launch_pass", _scrambling(launch_pass))
    got = render()
    for f in ("color", "hit", "depth", "normal"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert bool(want.hit.any()) and not bool(want.hit.all())
