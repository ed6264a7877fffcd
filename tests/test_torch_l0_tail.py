"""The level-0 tail, on the CPU: the exact tail as the CUDA kernel marches
it, one lane a ray (`march_pass_reference(l0_only=True)`, the plain version
of `march_common.cuh::l0_min_steps`), and the serial walk under the floor
alone that the latency probe models (`l0_min_step(hierarchy=False)`: the
level-0 step `l0_step` plus the floor exit under the map's lowest height).

They are held to JAX's level-0 step (`march_body.py::wavefront_step_l0`)
evaluated op by op from the entry cells of grazing rays, the rays that end
in the tail; and the exact tail is held to the per-ray budget the kernel
relies on: a pass of b steps and then the rest gives what one pass gives,
in every plane and count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
                                            l0_min_step, ray_box_range, ray_inverses,
                                            record_corners, run_masked)

torch.set_num_threads(2)  # the suite runs several workers at once

N = 65
CIS = ["triangle", "bilinear", "flat"]
BUDGETS = [1, 7, 33, UNBUDGETED]
#: the first pass's budgets of the resumed tail: inside a block pass, inside
#: a level-0 run, and past most rays' ends
FIRST_BUDGETS = [1, 7, 33, 256]
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


@pytest.fixture(scope="module")
def grazing_entry(scene):
    """Grazing rays at their box entry, in their entry cell at level 0, with
    no hit: march_pass's planes (rays, state, results)."""
    o, d = _grazing(p=128, seed=4)
    rays = _planes((o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]))
    ray = _ray(scene, rays)
    t0, _, valid = ray_box_range(ray[0], ray[1], ray[3], ray[4], float(scene.n - 1))
    icx, icy = entry_cell(ray[0], ray[1], ray[3], ray[4], t0, 0, scene.m)
    p = t0.shape[0]
    state = (valid.to(torch.int32), torch.where(valid, t0, BIG_T),
             torch.zeros(p, dtype=torch.int32), icx, icy)
    return rays, state, empty_results(p, "cpu")


def _state(st, res):
    alive, t, lvl, icx, icy = st
    hit, t_hit, hx, hy = res
    return dict(alive=alive != 0, t=t, lvl=lvl, icx=icx, icy=icy, hit=hit != 0, t_hit=t_hit,
                hx=hx, hy=hy)


def _below(sc, ray, ci):
    return below_margins(ray, sc.pyr_min_flat[-1], sc.pyr_flat[-1], m=sc.m, cell_intersect=ci)


def _tail(sc, rays, st, res, ci, budget):
    """One pass of the exact tail, one lane a ray, from (st, res): its
    (state, results) and its WorkCounter."""
    work = WorkCounter(sc.pyr_flat.shape[0], sc.n, "cpu", lanes=rays[0].shape[0])
    out = march_pass_reference(rays, st, res, sc.pyr_flat, sc.heights, n=sc.n, m=sc.m,
                               levels=sc.levels, budget=budget, cell_intersect=ci,
                               counter=work, l0_only=True, pyr_min=sc.pyr_min_flat)
    return out, work


@pytest.fixture(scope="module")
def jax_tail(scene, grazing_entry):
    """JAX's level-0 step evaluated op by op from the grazing rays' entry
    cells, per intersector: the 9 planes after 1, 7, 33 steps and at the end,
    and each ray's steps (the steps it started alive)."""
    sc = scene
    hf = jax_procedural_terrain(N, seed=3).reshape(-1)
    rays, state, res = grazing_entry
    ray = _ray(sc, rays)
    start = _state(state, res)
    jray = [jnp.asarray(x.numpy()) for x in ray]
    gmax = float(sc.pyr_flat[-1])
    p = rays[0].shape[0]
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
    return ray, start, out


def _assert_hits(got, want, ci):
    """(hit, t_hit, hx, hy) of `got` (torch) equal JAX's `want` (numpy): bit
    for bit, t_hit of a hit to T_RTOL."""
    hit = want["hit"] != 0
    np.testing.assert_array_equal(got["hit"].numpy(), hit, err_msg="hit")
    for k in ("hx", "hy"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    t_hit = got["t_hit"].numpy()
    np.testing.assert_allclose(t_hit[hit], want["t_hit"][hit], rtol=T_RTOL[ci], atol=0)
    np.testing.assert_array_equal(t_hit[~hit], want["t_hit"][~hit])


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("ci", CIS)
def test_serial_walk_matches_jax_op_by_op(scene, jax_tail, ci, budget):
    """The serial walk under the floor (`l0_min_step(hierarchy=False)`, the
    chain the latency probe models) from the grazing rays' entry cells
    equals JAX's level-0 step iterated op by op, at each budget: the hits
    bit for bit (t_hit of the bilinear model to T_RTOL, the intersectors'
    own bar), and every other plane and each ray's steps on the rays the
    floor exit did not end (JAX has none): those the floor ended stand
    under it, and JAX's walk never hits them."""
    ray, start, jax_out = jax_tail
    want, want_steps = jax_out[ci][budget]
    never = jax_out[ci][UNBUDGETED][0]["hit"] == 0
    corners = record_corners(scene.heights.reshape(-1), scene.n, scene.m)
    work = WorkCounter(scene.pyr_flat.shape[0], scene.n, "cpu", lanes=ray[0].shape[0])
    below = _below(scene, ray, ci)
    got = run_masked(lambda s: l0_min_step(ray, s, corners, scene.pyr_flat, scene.pyr_min_flat,
                                           scene.pyr_flat[-1], below, m=scene.m,
                                           levels=scene.levels, intersector=INTERSECTORS[ci],
                                           counter=work, hierarchy=False), start, budget)
    floored = np.zeros(never.shape, bool)
    if below is not None:
        z_end = ray[2] + got["t"] * ray[5]
        floored = (~got["alive"] & ~got["hit"] & (z_end < below[2])).numpy()
        assert never[floored].all()
    _assert_hits(got, want, ci)
    for k in ("alive", "t", "lvl", "icx", "icy"):
        g = got[k].numpy()
        w = want[k] != 0 if got[k].dtype == torch.bool else want[k]
        np.testing.assert_array_equal(g[~floored], w[~floored], err_msg=k)
    np.testing.assert_array_equal(work.lane_steps.numpy()[~floored], want_steps[~floored])
    if budget == UNBUDGETED:
        assert (want["hit"] != 0).any() and not (want["hit"] != 0).all()


@pytest.mark.parametrize("start", ["tail_start", "grazing_entry"])
@pytest.mark.parametrize("budget", FIRST_BUDGETS)
@pytest.mark.parametrize("ci", CIS)
def test_tail_resumes_across_passes(scene, request, ci, budget, start):
    """The exact tail, one lane a ray, in a pass of `budget` steps and then
    an unbudgeted pass equals one unbudgeted pass: all 9 planes bit for bit
    (the block level a ray stands at included), and each ray's steps and
    cell tests summed over the two passes. The kernel relies on this: its
    lanes march a ray in chunks and take the rays in any order."""
    rays, st, res = request.getfixturevalue(start)
    (st1, res1), w1 = _tail(scene, rays, st, res, ci, UNBUDGETED)
    (st_a, res_a), wa = _tail(scene, rays, st, res, ci, budget)
    (st2, res2), wb = _tail(scene, rays, st_a, res_a, ci, UNBUDGETED)
    for k, a, b in zip(PLANES, st2 + res2, st1 + res1):
        assert torch.equal(a, b), (k, int((a != b).sum()))
    assert torch.equal(wa.lane_steps + wb.lane_steps, w1.lane_steps)
    assert torch.equal(wa.lane_tests + wb.lane_tests, w1.lane_tests)
    assert not st1[0].any() and res1[0].any()
    if budget < 33:  # the first pass ends inside some rays' march
        assert st_a[0].any() and int(wb.steps) > 0


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("ci", CIS)
def test_tail_hits_match_jax_on_grazing_rays(scene, grazing_entry, jax_tail, ci, budget):
    """The exact tail, one lane a ray, in passes of `budget` steps to the end
    from the grazing rays' entry cells: its hits are those of JAX's level-0
    step iterated op by op, bit for bit (t_hit of the bilinear model to
    T_RTOL), though it passes under blocks and ends under the floor."""
    rays, st, res = grazing_entry
    _, _, jax_out = jax_tail
    want = jax_out[ci][UNBUDGETED][0]
    for _ in range(4 * N + 1):
        if not st[0].any():
            break
        (st, res), _ = _tail(scene, rays, st, res, ci, budget)
    assert not st[0].any(), "the tail did not end"
    _assert_hits(_state(st, res), want, ci)
    assert (want["hit"] != 0).any() and not (want["hit"] != 0).all()


@pytest.mark.parametrize("l0_only", [True, torch.tensor(True), torch.tensor(False)],
                         ids=["true", "flag_true", "flag_false"])
def test_march_pass_tail_flag_on_the_cpu(scene, tail_start, l0_only):
    """march_pass on a CPU scene, from the compact path's tail start, takes
    the exact tail as a bool or as a 0-dim flag and gives the plain version
    run with the bool; a false flag gives the max-mip pass."""
    rays, st, res = tail_start
    kw = dict(n=scene.n, m=scene.m, levels=scene.levels, budget=UNBUDGETED)
    args = (rays, st, res, scene.pyr_flat, scene.heights)
    got = march_pass(*args, scene.corners, l0_only=l0_only, pyr_min=scene.pyr_min_flat, **kw)
    want = march_pass_reference(*args, l0_only=bool(l0_only), pyr_min=scene.pyr_min_flat, **kw)
    for k, a, b in zip(PLANES, got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b), k
    if not bool(l0_only):
        maxmip = march_pass_reference(*args, **kw)
        for k, a, b in zip(PLANES, got[0] + got[1], maxmip[0] + maxmip[1]):
            assert torch.equal(a, b), k
    assert not got[0][0].any() and got[1][0].any()
