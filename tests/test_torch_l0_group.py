"""The level-0 tail by lane groups, on the CPU: `traversal/march.py::
l0_group_march`, the tensor form of the CUDA kernel's group march
(`march_common.cuh::l0_group_steps`), held bit for bit against the serial
walk it takes (`l0_min_step(hierarchy=False)`: the level-0 step `l0_step`
plus the floor exit under the map's lowest height, iterated) and in hits
against JAX's (`march_body.py::wavefront_step_l0`) evaluated op by op; and
march_pass's `group` on the CPU.

The window form rests on three facts these tests check: the cells of a
ray's level-0 DDA are the merge of its x and y boundary exit sequences,
ties going to x; the t a cell is entered at is the max of the earlier
cells' exits; and the first cell of a window that ends the ray gives the
ray the state the serial march leaves it in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as hs

import hmrt_tpu_torch as T
from conftest import random_rays
from hmrt_tpu.io.heightmap import procedural_terrain as jax_procedural_terrain
from hmrt_tpu.kernels.march_body import wavefront_step_l0 as jax_step_l0
from hmrt_tpu.traversal.intersect import INTERSECTORS as JAX_INTERSECTORS
from hmrt_tpu.traversal.march import corner_heights as jax_corner_heights
from hmrt_tpu_torch.kernels.compact import empty_results, init_state
from hmrt_tpu_torch.kernels.march_pass import UNBUDGETED, march_pass, march_pass_reference
from hmrt_tpu_torch.kernels.ray_sort import force_level0
from hmrt_tpu_torch.traversal.intersect import BIG_T, INTERSECTORS
from hmrt_tpu_torch.traversal.march import (WorkCounter, below_margins, entry_cell,
                                            l0_group_march, l0_min_step, ray_box_range,
                                            ray_inverses, record_corners, run_masked)

torch.set_num_threads(2)  # the suite runs several workers at once

N = 65
CIS = ["triangle", "bilinear", "flat"]
GROUPS = [4, 32]
BUDGETS = [1, 7, 33, UNBUDGETED]
PLANES = ("alive", "t", "lvl", "icx", "icy", "hit", "t_hit", "hx", "hy")
#: relative bar on t_hit against JAX op by op: bit-equal for the triangle
#: and flat models; the bilinear root solve within 1e-3, as in
#: tests/test_torch_march.py (ROADMAP.md section 3)
T_RTOL = {"triangle": 0.0, "flat": 0.0, "bilinear": 1e-3}


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


def _grazing(p=256, seed=0):
    """Near-horizontal rays from just outside the y=0 edge, 0.3-1.1 of the
    terrain's height up: the rays that end in the level-0 tail."""
    rng = np.random.default_rng(seed)
    hmax = float(T.procedural_terrain(N, seed=3).max())
    o = np.stack([rng.uniform(0, N - 1, p), np.full(p, -0.5),
                  rng.uniform(0.3 * hmax, 1.1 * hmax, p)], -1)
    d = np.stack([rng.uniform(-0.3, 0.3, p), np.ones(p), rng.uniform(-0.05, 0.02, p)], -1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.fixture(scope="module")
def tail_start(scene):
    """Mixed and grazing rays, and the state a budgeted max-mip pass and
    force_level0 leave them in: where the compact path's tail starts."""
    o, d = random_rays(384, N, seed=1)
    og, dg = _grazing()
    o, d = np.concatenate([o, og]), np.concatenate([d, dg])
    rays = _planes((o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]))
    p = rays[0].shape[0]
    st = init_state(rays, None, scene.pyr_flat[-1], n=scene.n, m=scene.m, levels=scene.levels)
    st, res = march_pass_reference(rays, st, empty_results(p, "cpu"), scene.pyr_flat,
                                   scene.heights, n=scene.n, m=scene.m, levels=scene.levels,
                                   budget=6)
    return rays, force_level0(rays, st), res


def _state(st, res):
    alive, t, lvl, icx, icy = st
    hit, t_hit, hx, hy = res
    return dict(alive=alive != 0, t=t, lvl=lvl, icx=icx, icy=icy, hit=hit != 0, t_hit=t_hit,
                hx=hx, hy=hy)


def _below(sc, ray, ci):
    return below_margins(ray, sc.pyr_min_flat[-1], sc.pyr_flat[-1], m=sc.m, cell_intersect=ci)


def _both(sc, ray, st, ci, group, budget):
    """The serial walk of the lane groups (`l0_min_step` without the
    hierarchy: the level-0 step and the floor exit) and the group march
    from `st`, each with its WorkCounter."""
    corners = record_corners(sc.heights.reshape(-1), sc.n, sc.m)
    gmax = sc.pyr_flat[-1]
    below = _below(sc, ray, ci)
    kw = dict(m=sc.m, intersector=INTERSECTORS[ci])
    p = ray[0].shape[0]
    ws, wg = (WorkCounter(sc.pyr_flat.shape[0], sc.n, "cpu", lanes=p) for _ in range(2))
    serial = run_masked(lambda s: l0_min_step(ray, s, corners, sc.pyr_flat, sc.pyr_min_flat,
                                              gmax, below, levels=sc.levels, counter=ws,
                                              hierarchy=False, **kw), st, budget)
    grouped = l0_group_march(ray, st, corners, gmax, group=group, budget=budget, counter=wg,
                             zfloor=None if below is None else below[2], **kw)
    return (serial, ws), (grouped, wg)


def _assert_same(a, b, wa, wb):
    for k in PLANES:
        assert torch.equal(a[k], b[k]), (k, int((a[k] != b[k]).sum()))
    assert torch.equal(wa.lane_steps, wb.lane_steps)
    assert torch.equal(wa.lane_tests, wb.lane_tests)
    assert torch.equal(wa.pyr_reads, wb.pyr_reads)
    assert torch.equal(wa.height_reads, wb.height_reads)


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("ci", CIS)
def test_group_march_equals_serial(scene, tail_start, ci, group, budget):
    """From the tail's start state, the group march equals the serial
    walk it takes (the level-0 step and the floor exit) in all 9 planes,
    per-ray steps and cell tests, and the terrain read, at budgets that end
    rays inside a window and unbudgeted."""
    rays, st, res = tail_start
    (a, wa), (b, wb) = _both(scene, _ray(scene, rays), _state(st, res), ci, group, budget)
    _assert_same(a, b, wa, wb)
    assert int(wa.steps) > 0 and a["hit"].any()
    if budget == UNBUDGETED:
        assert not a["alive"].any()


@pytest.fixture(scope="module")
def jax_tail():
    """JAX's level-0 step evaluated op by op from the grazing rays' entry
    cells, per intersector: the 9 planes after 1, 7, 33 steps and at the end,
    and each ray's steps (the steps it started alive)."""
    sc = T.make_scene(T.procedural_terrain(N, seed=3), device="cpu")
    hf = jax_procedural_terrain(N, seed=3).reshape(-1)
    o, d = _grazing(p=128, seed=4)
    planes = [np.ascontiguousarray(a, np.float32)
              for a in (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])]
    ray = _ray(sc, tuple(map(torch.from_numpy, planes)))
    t0, _, valid = ray_box_range(ray[0], ray[1], ray[3], ray[4], float(sc.n - 1))
    icx, icy = entry_cell(ray[0], ray[1], ray[3], ray[4], t0, 0, sc.m)
    p = t0.shape[0]
    start = dict(t=torch.where(valid, t0, BIG_T), lvl=torch.zeros(p, dtype=torch.int32),
                 icx=icx, icy=icy, alive=valid, hit=torch.zeros(p, dtype=torch.bool),
                 t_hit=torch.full((p,), BIG_T), hx=torch.zeros(p, dtype=torch.int32),
                 hy=torch.zeros(p, dtype=torch.int32))
    jray = [jnp.asarray(x.numpy()) for x in ray]
    gmax = float(sc.pyr_flat[-1])
    out = {}
    for ci in CIS:
        jst = {k: jnp.asarray(v.numpy().astype(np.int32) if v.dtype == torch.bool else v.numpy())
               for k, v in start.items()}
        steps = np.zeros(p, np.int32)
        snaps = {}
        with jax.disable_jit():
            k = 0
            while bool(jnp.any(jst["alive"] != 0)):
                assert k < 4 * N, "the level-0 march did not end"
                steps += np.asarray(jst["alive"]) != 0
                jst = jax_step_l0(jst, jst["alive"] != 0, *jray, gmax,
                                  lambda s=jst: jax_corner_heights(hf, N, s["icx"], s["icy"]),
                                  m=sc.m, intersector=JAX_INTERSECTORS[ci])
                k += 1
                if k in BUDGETS:
                    snaps[k] = ({n: np.asarray(v) for n, v in jst.items()}, steps.copy())
        for b in BUDGETS[:-1]:
            snaps.setdefault(b, ({n: np.asarray(v) for n, v in jst.items()}, steps.copy()))
        snaps[UNBUDGETED] = ({n: np.asarray(v) for n, v in jst.items()}, steps.copy())
        out[ci] = snaps
    return sc, ray, start, out


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("ci", CIS)
def test_group_march_matches_jax_op_by_op(jax_tail, ci, group, budget):
    """The group march from the grazing rays' entry cells equals JAX's
    level-0 step iterated op by op, at each budget: the hits bit for bit
    (t_hit of the bilinear model to T_RTOL, the intersectors' own bar), and
    every other plane and each ray's steps on the rays the floor exit did
    not end (JAX has none): those the floor ended stand under it, and JAX's
    walk never hits them."""
    sc, ray, start, jax_out = jax_tail
    want, want_steps = jax_out[ci][budget]
    never = jax_out[ci][UNBUDGETED][0]["hit"] == 0
    corners = record_corners(sc.heights.reshape(-1), sc.n, sc.m)
    work = WorkCounter(sc.pyr_flat.shape[0], sc.n, "cpu", lanes=ray[0].shape[0])
    below = _below(sc, ray, ci)
    got = l0_group_march(ray, start, corners, sc.pyr_flat[-1], m=sc.m,
                         intersector=INTERSECTORS[ci], group=group, budget=budget,
                         counter=work, zfloor=None if below is None else below[2])
    floored = np.zeros(never.shape, bool)
    if below is not None:
        z_end = ray[2] + got["t"] * ray[5]
        floored = (~got["alive"] & ~got["hit"] & (z_end < below[2])).numpy()
        assert never[floored].all()
    hit = want["hit"] != 0
    for k in PLANES:
        g = got[k].numpy()
        w = want[k] != 0 if got[k].dtype == torch.bool else want[k]
        if k == "t_hit":
            np.testing.assert_allclose(g[hit], w[hit], rtol=T_RTOL[ci], atol=0)
            np.testing.assert_array_equal(g[~hit], w[~hit])
        elif k in ("hit", "hx", "hy"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_array_equal(g[~floored], w[~floored], err_msg=k)
    np.testing.assert_array_equal(work.lane_steps.numpy()[~floored], want_steps[~floored])
    if budget == UNBUDGETED:
        assert hit.any() and not hit.all()


def _special_rays(draw_o, draw_d):
    """Ray planes from drawn origins and directions (lists of 3-tuples)."""
    o = np.array(draw_o, np.float64)
    d = np.array(draw_d, np.float64)
    nrm = np.linalg.norm(d, axis=1, keepdims=True)
    d = np.where(nrm > 0, d / np.where(nrm > 0, nrm, 1.0), d)
    return _planes((o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]))


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
def test_group_march_special_rays(scene, data):
    """Drawn rays: axis-parallel, components below TINY, negative
    directions, exact tx == ty ties (equal |dx| and |dy| from a cell's
    centre), starts on the grid's edges and lines, rays that leave at once,
    and rays that start inside the terrain; from their entry cell, the group
    march equals the serial walk it takes in all planes and counts, with
    each model, G and budget."""
    p = 8
    origins, dirs = [], []
    for _ in range(p):
        kind = data.draw(hs.sampled_from(["any", "tie", "edge", "leave"]))
        ox, oy = data.draw(_COORD), data.draw(_COORD)
        oz = data.draw(hs.floats(-5.0, 40.0, width=32))
        dx, dy = data.draw(_COMP), data.draw(_COMP)
        dz = data.draw(hs.floats(-0.5, 0.5, width=32))
        if kind == "tie":
            ox, oy = float(int(abs(ox)) % (N - 1)) + 0.5, float(int(abs(oy)) % (N - 1)) + 0.5
            s = data.draw(hs.sampled_from([1.0, -1.0]))
            dy = s * dx if dx != 0 else 0.7
            dx = dx if dx != 0 else 0.7
        elif kind == "edge":
            ox = data.draw(hs.sampled_from([0.0, float(N - 1)]))
        elif kind == "leave":  # at the box's exit side, pointing out
            ox, dx = float(N - 1) - 1e-4, abs(dx) + 0.1
        origins.append((ox, oy, oz))
        dirs.append((dx, dy, dz))
    rays = _special_rays(origins, dirs)
    ray = _ray(scene, rays)
    t0, _, valid = ray_box_range(ray[0], ray[1], ray[3], ray[4], float(scene.n - 1))
    icx, icy = entry_cell(ray[0], ray[1], ray[3], ray[4], t0, 0, scene.m)
    st = dict(t=torch.where(valid, t0, BIG_T), lvl=torch.zeros(p, dtype=torch.int32), icx=icx,
              icy=icy, alive=valid, hit=torch.zeros(p, dtype=torch.bool),
              t_hit=torch.full((p,), BIG_T), hx=torch.zeros(p, dtype=torch.int32),
              hy=torch.zeros(p, dtype=torch.int32))
    ci = data.draw(hs.sampled_from(CIS))
    group = data.draw(hs.sampled_from(GROUPS))
    budget = data.draw(hs.sampled_from(BUDGETS))
    (a, wa), (b, wb) = _both(scene, ray, st, ci, group, budget)
    _assert_same(a, b, wa, wb)


@pytest.mark.parametrize("group", ["auto", 1, 32])
def test_march_pass_group_on_the_cpu(scene, tail_start, group):
    """march_pass takes the tail's `group` on a CPU scene and gives the plain
    version of that group's walk (one lane a ray for 1 and "auto"), whose
    hits are the same whatever it is; a group it does not define, or one
    outside the exact level-0 tail, raises before anything runs."""
    rays, st, res = tail_start
    kw = dict(n=scene.n, m=scene.m, levels=scene.levels, budget=UNBUDGETED)
    args = (rays, st, res, scene.pyr_flat, scene.heights)
    got = march_pass(*args, scene.corners, l0_only=True, group=group, **kw)
    want = march_pass_reference(*args, l0_only=True, group=group, **kw)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b)
    one = march_pass_reference(*args, l0_only=True, group=1, **kw)
    for a, b in zip(got[1], one[1]):
        assert torch.equal(a, b)
    for bad in (dict(l0_only=True, group=4), dict(l0_only=False, group=32),
                dict(l0_only=True, relax=4, group=32), dict(l0_only=True, group="32")):
        with pytest.raises(ValueError, match="group"):
            march_pass(*args, scene.corners, **{**kw, **bad})
    if group != "auto":
        with pytest.raises(ValueError, match="group"):
            march_pass(*args, scene.corners, group=group, **kw)
