"""The grazing tail of the compact path: the port's level-0 steps
(`l0_step`, `l0_step_relaxed`), `force_level0`, the tail modes of the march
kernel's plain version and `render_frame_compact(l0_tail=, relax=)`, held
against the JAX package.

The steps are held against JAX's own (`march_body.py::wavefront_step_l0`
and `wavefront_step_l0_relaxed`) evaluated op by op, since XLA contracts
multiply-adds when it compiles. The relaxed FRAME cannot equal JAX's pixel
for pixel: where a ray enters the tail depends on the schedule, and that
decides where its samples fall. So frames are held to JAX's contract
(tests/test_relaxed.py): no false hits; a detected hit is the exact hit;
a small share of tunnelled hits, no larger at a finer stride; and a ramp,
where every crossing is unique, rendered exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hmrt_tpu_torch as T
from conftest import random_rays
from hmrt_tpu.api.scene import make_scene as jax_make_scene
from hmrt_tpu.config import RenderConfig as JaxRenderConfig
from hmrt_tpu.core.renderer import render_frame_oracle as jax_render_frame_oracle
from hmrt_tpu.io.heightmap import procedural_terrain
from hmrt_tpu.kernels.compact import _force_level0 as jax_force_level0
from hmrt_tpu.kernels.march_body import (wavefront_step_l0 as jax_step_l0,
                                         wavefront_step_l0_relaxed as jax_step_relaxed)
from hmrt_tpu.traversal.intersect import (INTERSECTORS as JAX_INTERSECTORS,
                                          SURFACES as JAX_SURFACES)
from hmrt_tpu.traversal.march import corner_heights as jax_corner_heights
from hmrt_tpu.types import Camera as JaxCamera
from hmrt_tpu_torch.api.scene import scene_from_arrays
from hmrt_tpu_torch.core.renderer import render_frame_oracle
from hmrt_tpu_torch.kernels.compact import empty_results, init_state, render_frame_compact
from hmrt_tpu_torch.kernels.march_pass import (UNBUDGETED, march_pass,
                                               march_pass_reference)
from hmrt_tpu_torch.kernels.ray_sort import L0_TAIL_AUTO_THRESH, force_level0, l0_tail_flag
from hmrt_tpu_torch.traversal.intersect import BIG_T, INTERSECTORS, SURFACES
from hmrt_tpu_torch.traversal.march import (WorkCounter, entry_cell, l0_step,
                                            l0_step_relaxed, ray_box_range, ray_inverses,
                                            record_corners, relaxed_planes)

torch.set_num_threads(2)  # the suite runs several workers at once

N = 65
CIS = ["triangle", "bilinear", "flat"]
#: relative bar on t at a hit against JAX: bit-equal for the triangle and
#: flat models op by op; the bilinear root solve is held to 1e-3, as in
#: tests/test_torch_march.py (ROADMAP.md section 3)
T_RTOL = {"triangle": 0.0, "flat": 0.0, "bilinear": 1e-3}
#: the small schedule that sends most rays of a test frame into the tail
SMALL = dict(first_budget=8, round_budget=16)


@pytest.fixture(scope="module")
def scenes():
    js = jax_make_scene(procedural_terrain(N, seed=3), pack=False)
    light = {f.name: np.asarray(getattr(js.light, f.name))
             for f in dataclasses.fields(js.light)}
    ts = scene_from_arrays(np.asarray(js.heights), np.asarray(js.pyr_flat), None, light,
                           n=js.n, m=js.m, levels=js.levels, device="cpu")
    return js, ts


def _grazing_rays(n, p=256, seed=0):
    """Near-horizontal rays from just outside the y=0 edge, 0.3-1.1 of the
    terrain's height up: the rays that end in the level-0 tail."""
    rng = np.random.default_rng(seed)
    hmax = float(np.asarray(procedural_terrain(n, seed=3)).max())
    o = np.stack([rng.uniform(0, n - 1, p), np.full(p, -0.5),
                  rng.uniform(0.3 * hmax, 1.1 * hmax, p)], -1)
    d = np.stack([rng.uniform(-0.3, 0.3, p), np.ones(p), rng.uniform(-0.05, 0.02, p)], -1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return [np.ascontiguousarray(a, np.float32)
            for a in (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])]


def _level0_start(ts, planes):
    """Ray constants and the level-0 start state (at the entry cell) of the
    ray planes, as numpy arrays both packages start from."""
    r = [torch.from_numpy(a) for a in planes]
    inv_x, inv_y = ray_inverses(r[3], r[4])
    t0, t1, valid = ray_box_range(r[0], r[1], r[3], r[4], float(ts.n - 1))
    icx, icy = entry_cell(r[0], r[1], r[3], r[4], t0, 0, ts.m)
    ray = [*planes, inv_x.numpy(), inv_y.numpy(), t1.numpy()]
    return ray, dict(t=torch.where(valid, t0, BIG_T).numpy(), icx=icx.numpy(),
                     icy=icy.numpy(), alive=valid.numpy())


@pytest.mark.parametrize("mode", ["exact", 4, 8])
@pytest.mark.parametrize("ci", CIS)
def test_l0_steps_match_jax_op_by_op(scenes, ci, mode):
    """From one state, the port's level-0 step looped to the end equals
    JAX's evaluated op by op: hit, hx, hy equal; t_hit to T_RTOL."""
    js, ts = scenes
    ray_np, st_np = _level0_start(ts, _grazing_rays(N))
    p = ray_np[0].shape[0]
    hf_j = js.heights.reshape(-1)
    gmax = float(ts.pyr_flat[-1])

    jray = [jnp.asarray(a) for a in ray_np]
    jst = dict(t=jnp.asarray(st_np["t"]), icx=jnp.asarray(st_np["icx"]),
               icy=jnp.asarray(st_np["icy"]), alive=jnp.asarray(st_np["alive"].astype(np.int32)),
               lvl=jnp.zeros(p, jnp.int32), hit=jnp.zeros(p, jnp.int32),
               t_hit=jnp.full(p, BIG_T, jnp.float32), hx=jnp.zeros(p, jnp.int32),
               hy=jnp.zeros(p, jnp.int32))
    tray = [torch.from_numpy(a) for a in ray_np]
    tst = dict(t=torch.from_numpy(st_np["t"]), icx=torch.from_numpy(st_np["icx"]),
               icy=torch.from_numpy(st_np["icy"]), alive=torch.from_numpy(st_np["alive"]),
               lvl=torch.zeros(p, dtype=torch.int32), hit=torch.zeros(p, dtype=torch.bool),
               t_hit=torch.full((p,), BIG_T), hx=torch.zeros(p, dtype=torch.int32),
               hy=torch.zeros(p, dtype=torch.int32))
    if mode != "exact":
        jst.update(rmode=jnp.zeros(p, jnp.int32), tprev=jst["t"],
                   wend=jnp.full(p, BIG_T, jnp.float32))
        tst.update(relaxed_planes(tst["t"]))
    corners = record_corners(ts.heights.reshape(-1), ts.n, ts.m)

    steps = 0
    with jax.disable_jit():
        while bool(jnp.any(jst["alive"] != 0)):
            assert steps < 4 * N, "the level-0 march did not end"
            cf = (lambda s=jst: jax_corner_heights(hf_j, N, s["icx"], s["icy"]))
            kw = dict(m=js.m, intersector=JAX_INTERSECTORS[ci])
            if mode == "exact":
                jst = jax_step_l0(jst, jst["alive"] != 0, *jray, gmax, cf, **kw)
                tst = l0_step(tray, tst, corners, gmax, m=ts.m, intersector=INTERSECTORS[ci])
            else:
                jst = jax_step_relaxed(jst, jst["alive"] != 0, *jray, gmax, cf, **kw,
                                       surface=JAX_SURFACES[ci], stride=mode)
                tst = l0_step_relaxed(tray, tst, corners, gmax, m=ts.m,
                                      intersector=INTERSECTORS[ci], surface=SURFACES[ci],
                                      stride=mode)
            steps += 1
    assert not tst["alive"].any()
    hit = np.asarray(jst["hit"]) != 0
    np.testing.assert_array_equal(tst["hit"].numpy(), hit)
    np.testing.assert_array_equal(tst["hx"].numpy()[hit], np.asarray(jst["hx"])[hit])
    np.testing.assert_array_equal(tst["hy"].numpy()[hit], np.asarray(jst["hy"])[hit])
    np.testing.assert_allclose(tst["t_hit"].numpy()[hit], np.asarray(jst["t_hit"])[hit],
                               rtol=T_RTOL[ci], atol=0)
    assert hit.any() and not hit.all()


@pytest.mark.parametrize("ci", CIS)
def test_surfaces_match_jax_op_by_op(ci):
    """Each surface evaluator equals JAX's, bit for bit, on random cells."""
    rng = np.random.default_rng(11)
    args = [rng.uniform(0, 1, 4096).astype(np.float32) for _ in range(2)] \
        + [rng.uniform(0, 9, 4096).astype(np.float32) for _ in range(4)]
    with jax.disable_jit():
        want = np.asarray(JAX_SURFACES[ci](*map(jnp.asarray, args)))
    got = SURFACES[ci](*map(torch.from_numpy, args)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("m", [64, 4096])
def test_force_level0_bit_equal_to_jax(m):
    """force_level0 equals JAX's levels-1 rounds of descend_cell in all five
    planes: at every level, on cells that do and do not hold the position,
    and on finished lanes (t = BIG_T)."""
    rng = np.random.default_rng(m)
    levels, p = m.bit_length(), 8192
    o = rng.uniform(-10, m + 10, (p, 3)).astype(np.float32)
    d = rng.normal(size=(p, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = rng.uniform(0, m, p).astype(np.float32)
    t[:64] = BIG_T
    lvl = rng.integers(0, levels, p).astype(np.int32)
    side = m >> lvl
    icx = np.clip(np.floor((o[:, 0] + t * d[:, 0]) / (1 << lvl)), -1, side).astype(np.int32)
    icy = np.clip(np.floor((o[:, 1] + t * d[:, 1]) / (1 << lvl)), -1, side).astype(np.int32)
    icx[100:300] = rng.integers(-2, 6, 200)
    rays = [np.ascontiguousarray(o[:, i]) for i in range(3)] \
        + [np.ascontiguousarray(d[:, i]) for i in range(3)]
    state = (rng.integers(0, 2, p).astype(np.int32), t, lvl, icx, icy)
    want = jax_force_level0(tuple(map(jnp.asarray, rays)), tuple(map(jnp.asarray, state)),
                            levels)
    got = force_level0(tuple(map(torch.from_numpy, rays)), tuple(map(torch.from_numpy, state)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not got[2].any()


def _march_to_end(ts, rays, state, ci, **kw):
    return march_pass_reference(rays, state, empty_results(rays[0].shape[0], "cpu"),
                                ts.pyr_flat, ts.heights, n=ts.n, m=ts.m, levels=ts.levels,
                                budget=UNBUDGETED, cell_intersect=ci, **kw)


@pytest.mark.parametrize("budget", [7, 40])
@pytest.mark.parametrize("ci", CIS)
def test_l0_tail_after_budgeted_passes_equals_maxmip(scenes, ci, budget):
    """A budgeted max-mip pass, force_level0, then the unbudgeted l0_only
    pass give the unbudgeted max-mip march's hits: hit, t_hit, hx, hy
    equal, on mixed and grazing rays."""
    _, ts = scenes
    o, d = random_rays(384, N, seed=2)
    planes = [np.ascontiguousarray(a, np.float32) for a in
              (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])]
    planes = [np.concatenate([a, b]) for a, b in zip(planes, _grazing_rays(N, 128, seed=1))]
    rays = tuple(torch.from_numpy(a) for a in planes)
    st0 = init_state(rays, None, ts.pyr_flat[-1], n=ts.n, m=ts.m, levels=ts.levels)
    _, want = _march_to_end(ts, rays, st0, ci)
    st, res = march_pass_reference(rays, st0, empty_results(rays[0].shape[0], "cpu"),
                                   ts.pyr_flat, ts.heights, n=ts.n, m=ts.m, levels=ts.levels,
                                   budget=budget, cell_intersect=ci)
    assert st[0].any() and st[2][st[0] != 0].any()  # survivors above level 0
    st = force_level0(rays, st)
    _, got = march_pass_reference(rays, st, res, ts.pyr_flat, ts.heights, n=ts.n, m=ts.m,
                                  levels=ts.levels, budget=UNBUDGETED, cell_intersect=ci,
                                  l0_only=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_march_pass_tail_modes_on_cpu_count_and_equal_plain(scenes):
    """The wrapper on CPU tensors runs the plain tail modes, counting as the
    kernel's counting instance does: a step per iteration, and the exact
    tests (every walk iteration of the relaxed tail)."""
    _, ts = scenes
    rays = tuple(torch.from_numpy(a) for a in _grazing_rays(N, 128, seed=3))
    st = force_level0(rays, init_state(rays, None, ts.pyr_flat[-1], n=ts.n, m=ts.m,
                                       levels=ts.levels))
    p = rays[0].shape[0]
    kw = dict(n=ts.n, m=ts.m, levels=ts.levels, budget=UNBUDGETED)
    for l0_only, relax in ((True, 0), (True, 4), (torch.tensor(True), 8),
                           (torch.tensor(False), 8)):
        counts = torch.empty((2, p), dtype=torch.int32)
        got = march_pass(rays, st, empty_results(p, "cpu"), ts.pyr_flat, ts.heights,
                         ts.corners, counts=counts, l0_only=l0_only, relax=relax, **kw)
        work = WorkCounter(ts.pyr_flat.shape[0], ts.n, "cpu", lanes=p)
        want = march_pass_reference(rays, st, empty_results(p, "cpu"), ts.pyr_flat,
                                    ts.heights, counter=work, l0_only=bool(l0_only),
                                    relax=relax if bool(l0_only) else 0, **kw)
        for a, b in zip(got[0] + got[1], want[0] + want[1]):
            assert torch.equal(a, b)
        assert torch.equal(counts[0], work.lane_steps)
        assert torch.equal(counts[1], work.lane_tests)
        assert int(counts[1].sum()) > 0


def test_l0_tail_flag_threshold():
    """"auto" forces the tail when more than L0_TAIL_AUTO_THRESH of the
    alive lanes are at level 0 (dead lanes do not count)."""
    def state(alive, lvl):
        a = torch.tensor(alive, dtype=torch.int32)
        z = torch.zeros_like(a)
        return (a, z.float(), torch.tensor(lvl, dtype=torch.int32), z, z)
    k = 100
    at0 = int(L0_TAIL_AUTO_THRESH * k)
    assert not bool(l0_tail_flag(state([1] * k, [0] * at0 + [3] * (k - at0))))
    assert bool(l0_tail_flag(state([1] * k, [0] * (at0 + 1) + [3] * (k - at0 - 1))))
    assert bool(l0_tail_flag(state([1] * 10 + [0] * 90, [0] * 10 + [5] * 90)))
    assert not bool(l0_tail_flag(state([0] * 4, [0] * 4)))


def _frames_equal(a, b):
    for f in ("color", "depth", "normal", "hit"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert torch.equal(x, y), f


@pytest.mark.parametrize("sched", ["default", "small"])
@pytest.mark.parametrize("ci", CIS)
def test_every_l0_tail_gives_the_same_frame(ci, sched):
    """With relax=0, l0_tail False, True and "auto" give bit-equal frames
    (forcing level 0 only gives up skips), equal to the oracle's hits."""
    terr = procedural_terrain(128, seed=3)
    sc = T.make_scene(terr, device="cpu")
    cam = T.Camera.create(eye=(64, -42, float(terr.max()) + 2.0),
                          target=(64, 64, float(terr.mean())), device="cpu")
    cfg = T.RenderConfig(width=96, height=32, shading="phong", shadows=True,
                         aux_buffers=True, cell_intersect=ci)
    kw = SMALL if sched == "small" else {}
    frames = {lt: render_frame_compact(sc, cam, cfg, l0_tail=lt, **kw)
              for lt in (False, True, "auto")}
    _frames_equal(frames[False], frames[True])
    _frames_equal(frames[False], frames["auto"])
    assert torch.equal(frames[False].hit, render_frame_oracle(sc, cam, cfg).hit)


def _cam(n, zmax, zmean, lift=None):
    eye = (n / 2, -n / 3, zmax + (n / 6 if lift is None else lift))
    return eye, (n / 2, n / 2, zmean)


@pytest.fixture(scope="module")
def ramp():
    """A monotone ramp: for a descending ray the height above the surface
    falls monotonically, so every crossing is unique and no stride can
    tunnel."""
    n = 128
    terr = np.broadcast_to(np.arange(n, dtype=np.float32) * 0.2, (n, n)).copy()
    return terr, T.make_scene(terr, device="cpu"), jax_make_scene(terr, pack=False)


@pytest.fixture(scope="module")
def rough():
    terr = procedural_terrain(128, seed=3)
    return terr, T.make_scene(terr, device="cpu")


def test_relaxed_exact_on_ramp(ramp):
    """On the ramp the relaxed frame (stride 8) equals the exact tail's bit
    for bit, and its hit mask equals the JAX oracle's."""
    terr, sc, js = ramp
    eye, tgt = _cam(128, float(terr.max()), float(terr.mean()))
    cfg = T.RenderConfig(width=128, height=32, aux_buffers=True)
    cam = T.Camera.create(eye=eye, target=tgt, device="cpu")
    fr = render_frame_compact(sc, cam, cfg, l0_tail=True, relax=8, **SMALL)
    fe = render_frame_compact(sc, cam, cfg, l0_tail=True, **SMALL)
    _frames_equal(fr, fe)
    fj = jax_render_frame_oracle(js, JaxCamera.create(eye=eye, target=tgt),
                                 JaxRenderConfig(width=128, height=32, aux_buffers=True))
    np.testing.assert_array_equal(fr.hit.numpy(), np.asarray(fj.hit))
    assert fr.hit.any() and not fr.hit.all()


def test_relaxed_fidelity_bounds_on_rough(rough):
    """A grazing camera over 128^2 fBm at strides 16 then 4: no false hits,
    no detected hit earlier than the exact one (- 1e-3), hits at the exact
    crossing bit-tight, missed or late hits under 10% of the hits, and no
    more of them at the finer stride."""
    terr, sc = rough
    eye, tgt = _cam(128, float(terr.max()), float(terr.mean()), lift=2.0)
    cam = T.Camera.create(eye=eye, target=tgt, device="cpu")
    cfg = T.RenderConfig(width=256, height=64, aux_buffers=True)
    fo = render_frame_oracle(sc, cam, cfg)
    ohit, od = fo.hit, fo.depth
    prev = None
    tunnelled = 0
    for stride in (16, 4):
        fr = render_frame_compact(sc, cam, cfg, l0_tail=True, relax=stride, **SMALL)
        rhit, rd = fr.hit, fr.depth
        assert not (rhit & ~ohit).any(), stride
        both = rhit & ohit
        assert bool((rd[both] >= od[both] - 1e-3).all()), stride
        same = both & ((rd - od).abs() <= 1e-3)
        torch.testing.assert_close(rd[same], od[same], rtol=1e-6, atol=1e-4)
        mism = (rhit != ohit) | (both & ((rd - od).abs() > 1e-3))
        frac = int(mism.sum()) / max(int(ohit.sum()), 1)
        assert frac < 0.10, (stride, frac)
        if prev is not None:
            assert int(mism.sum()) <= prev + max(2, 0.02 * int(ohit.sum()))
        prev = int(mism.sum())
        tunnelled += prev
    assert tunnelled > 0  # the case does reach the relaxed tail's one error mode


def test_relaxed_with_shadows(rough):
    """The shadow march's tail is relaxed too: no false hits, at most 2% of
    the hits differ."""
    terr, sc = rough
    eye, tgt = _cam(128, float(terr.max()), float(terr.mean()))
    cam = T.Camera.create(eye=eye, target=tgt, device="cpu")
    cfg = T.RenderConfig(width=128, height=32, shading="phong", shadows=True)
    fr = render_frame_compact(sc, cam, cfg, l0_tail=True, relax=8, **SMALL)
    fo = render_frame_oracle(sc, cam, cfg)
    assert not (fr.hit & ~fo.hit).any()
    assert int((fr.hit != fo.hit).sum()) <= 0.02 * int(fo.hit.sum())
    assert bool(torch.isfinite(fr.color).all())


@pytest.mark.parametrize("l0_tail", [True, "auto"])
def test_relaxed_row_band(rough, l0_tail):
    """The relaxed tail in the band form of sharded rendering (rows
    [8, 16) of a 32-row screen): no false hits against the oracle's same
    rows, at most 2% of the hits differ."""
    terr, sc = rough
    eye, tgt = _cam(128, float(terr.max()), float(terr.mean()))
    cam = T.Camera.create(eye=eye, target=tgt, device="cpu")
    cfg = T.RenderConfig(width=128, height=8)
    fr = render_frame_compact(sc, cam, cfg, l0_tail=l0_tail, relax=8, row0=8,
                              full_height=32, **SMALL)
    fo = render_frame_oracle(sc, cam, cfg, row0=8, full_height=32)
    assert not (fr.hit & ~fo.hit).any()
    assert int((fr.hit != fo.hit).sum()) <= 0.02 * int(fo.hit.sum())
    assert fo.hit.any()


def test_relaxed_needs_the_tail_and_no_budget(scenes, rough):
    """relax > 0 with l0_tail=False raises, as does a budgeted relaxed pass
    (plain version and wrapper) and a relaxed pass outside the tail."""
    terr, sc = rough
    cam = T.Camera.create(eye=(64, -40, 60), target=(64, 64, 10), device="cpu")
    with pytest.raises(ValueError, match="level-0 tail"):
        render_frame_compact(sc, cam, T.RenderConfig(width=16, height=8), l0_tail=False,
                             relax=4)
    with pytest.raises(ValueError, match="l0_tail"):
        render_frame_compact(sc, cam, T.RenderConfig(width=16, height=8), l0_tail="yes")
    _, ts = scenes
    rays = tuple(torch.from_numpy(a) for a in _grazing_rays(N, 8))
    st = init_state(rays, None, ts.pyr_flat[-1], n=ts.n, m=ts.m, levels=ts.levels)
    res = empty_results(8, "cpu")
    kw = dict(n=ts.n, m=ts.m, levels=ts.levels)
    for fn, extra in ((march_pass_reference, ()), (march_pass, (ts.corners,))):
        with pytest.raises(ValueError, match="unbudgeted"):
            fn(rays, st, res, ts.pyr_flat, ts.heights, *extra, budget=64, l0_only=True,
               relax=4, **kw)
        with pytest.raises(ValueError, match="needs l0_only"):
            fn(rays, st, res, ts.pyr_flat, ts.heights, *extra, budget=UNBUDGETED, relax=4,
               **kw)
