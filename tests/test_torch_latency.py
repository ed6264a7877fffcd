"""The latency probe's walk on the CPU (`bench/latency.py::l0_walk`): the
level-0 tail's step on one ray that never stops, which ends, after the
steps the serial walk under the floor (`l0_min_step(hierarchy=False)`, a
cell a step) took on that ray, in the state that walk ends in. The probe's
kernel is held to the same plain walk on the card in
tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import hmrt_tpu_torch as T
from conftest import random_rays
from hmrt_tpu_torch.bench.latency import l0_walk, l0_walk_reference
from hmrt_tpu_torch.kernels.compact import empty_results, init_state
from hmrt_tpu_torch.kernels.march_pass import UNBUDGETED, march_pass_reference
from hmrt_tpu_torch.kernels.ray_sort import force_level0
from hmrt_tpu_torch.traversal.intersect import INTERSECTORS
from hmrt_tpu_torch.traversal.march import (WorkCounter, below_margins, l0_min_step,
                                            ray_box_range, ray_inverses, record_corners,
                                            run_masked)

torch.set_num_threads(2)  # the suite runs several workers at once

N = 65
CIS = ["triangle", "bilinear", "flat"]


@pytest.fixture(scope="module")
def scene():
    return T.make_scene(T.procedural_terrain(N, seed=3), device="cpu")


def _tail(sc, ci):
    """Random and grazing rays after 6 max-mip steps, forced to level 0, and
    their unbudgeted serial walk under the floor, with its per-ray counts:
    (rays, state, (state, results) at the end, WorkCounter)."""
    rng = np.random.default_rng(2)
    o, d = random_rays(192, N, seed=4)
    hmax = float(sc.heights.max())
    og = np.stack([rng.uniform(0, N - 1, 64), np.full(64, -0.5),
                   rng.uniform(0.3 * hmax, 1.1 * hmax, 64)], -1)
    dg = np.stack([rng.uniform(-0.3, 0.3, 64), np.ones(64), rng.uniform(-0.05, 0.02, 64)], -1)
    dg /= np.linalg.norm(dg, axis=1, keepdims=True)
    o, d = np.concatenate([o, og]), np.concatenate([d, dg])
    rays = tuple(torch.from_numpy(np.ascontiguousarray(x, np.float32))
                 for x in (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]))
    p = rays[0].shape[0]
    kw = dict(n=sc.n, m=sc.m, levels=sc.levels, cell_intersect=ci)
    st = init_state(rays, None, sc.pyr_flat[-1], n=sc.n, m=sc.m, levels=sc.levels)
    st, res = march_pass_reference(rays, st, empty_results(p, "cpu"), sc.pyr_flat, sc.heights,
                                   budget=6, **kw)
    st = force_level0(rays, st)
    ox, oy, oz, dx, dy, dz = rays
    inv_x, inv_y = ray_inverses(dx, dy)
    _, t1, _ = ray_box_range(ox, oy, dx, dy, float(sc.n - 1))
    ray = (ox, oy, oz, dx, dy, dz, inv_x, inv_y, t1)
    corners = record_corners(sc.heights.reshape(-1), sc.n, sc.m)
    below = below_margins(ray, sc.pyr_min_flat[-1], sc.pyr_flat[-1], m=sc.m, cell_intersect=ci)
    work = WorkCounter(sc.pyr_flat.shape[0], sc.n, "cpu", lanes=p)
    alive, t, lvl, icx, icy = st
    hit, t_hit, hx, hy = res
    end = run_masked(lambda s: l0_min_step(ray, s, corners, sc.pyr_flat, sc.pyr_min_flat,
                                           sc.pyr_flat[-1], below, m=sc.m, levels=sc.levels,
                                           intersector=INTERSECTORS[ci], counter=work,
                                           hierarchy=False),
                     dict(alive=alive != 0, t=t, lvl=lvl, icx=icx, icy=icy, hit=hit != 0,
                          t_hit=t_hit, hx=hx, hy=hy), UNBUDGETED)
    out = ((end["alive"].to(torch.int32), end["t"], end["lvl"], end["icx"], end["icy"]),
           (end["hit"].to(torch.int32), end["t_hit"], end["hx"], end["hy"]))
    return rays, st, out, work


def _one(planes, k):
    return tuple(x[k:k + 1].contiguous() for x in planes)


@pytest.mark.parametrize("ci", CIS)
def test_walk_ends_where_the_march_ends(scene, ci):
    """Walked for the steps the tail took on a ray, the walk ends with the
    march's t, cell, hit (and t_hit) and cell tests: on rays that hit, on
    rays that leave, and on the longest."""
    rays, st, (st_o, res_o), work = _tail(scene, ci)
    alive = torch.nonzero(st[0] != 0).squeeze(1)
    hits = alive[res_o[0][alive] != 0]
    misses = alive[res_o[0][alive] == 0]
    assert hits.numel() and misses.numel()
    picks = {*hits[:4].tolist(), *misses[:4].tolist(), int(torch.argmax(work.lane_steps))}
    for k in picks:
        steps = int(work.lane_steps[k])
        t, t_hit, icx, icy, hit, tests = l0_walk(_one(rays, k), _one(st, k), scene,
                                                 steps=steps, cell_intersect=ci)
        assert float(t) == float(st_o[1][k]), k
        assert (int(icx), int(icy)) == (int(st_o[3][k]), int(st_o[4][k])), k
        assert int(hit) == int(res_o[0][k]), k
        assert int(tests) == int(work.lane_tests[k]), k
        if int(hit):
            assert float(t_hit) == float(res_o[1][k]), k


def test_walk_goes_on_past_a_hit(scene):
    """A ray that hits keeps testing its hit cell: the state stays, and every
    further step is one more cell test."""
    rays, st, (st_o, res_o), work = _tail(scene, "triangle")
    k = int(torch.nonzero((st[0] != 0) & (res_o[0] != 0))[0])
    steps = int(work.lane_steps[k])
    at_end = l0_walk(_one(rays, k), _one(st, k), scene, steps=steps)
    later = l0_walk(_one(rays, k), _one(st, k), scene, steps=steps + 3)
    for a, b in zip(at_end[:5], later[:5]):
        assert torch.equal(a, b)
    assert int(later[5]) == int(at_end[5]) + 3


def test_walk_wrapper_on_the_cpu(scene):
    """On CPU tensors the wrapper is the plain walk and launches nothing; it
    takes one ray and a step count >= 0."""
    rays, st, _, _ = _tail(scene, "triangle")
    before = l0_walk.launches
    got = l0_walk(_one(rays, 3), _one(st, 3), scene, steps=17)
    want = l0_walk_reference(_one(rays, 3), _one(st, 3), scene, steps=17)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert l0_walk.launches == before
    with pytest.raises(ValueError, match="one ray"):
        l0_walk(tuple(x[:2] for x in rays), tuple(x[:2] for x in st), scene, steps=1)
    with pytest.raises(ValueError, match="steps"):
        l0_walk(_one(rays, 3), _one(st, 3), scene, steps=-1)
