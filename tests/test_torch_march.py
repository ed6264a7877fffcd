"""The port's march (oracle and the plain version of the march kernel) held
against the JAX package's march on identical input rays."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_rays
from hmrt_tpu.api.scene import make_scene as jax_make_scene
from hmrt_tpu.io.heightmap import procedural_terrain
from hmrt_tpu.kernels.compact import _init_state as jax_init_state
from hmrt_tpu.traversal.intersect import INTERSECTORS as JAX_INTERSECTORS
from hmrt_tpu.traversal.march import (march_dda as jax_march_dda,
                                      march_maxmip as jax_march_maxmip)
from hmrt_tpu_torch.api.scene import scene_from_arrays
from hmrt_tpu_torch.kernels.compact import init_state
from hmrt_tpu_torch.kernels.march_pass import (UNBUDGETED, march_pass,
                                               march_pass_reference)
from hmrt_tpu_torch.traversal.intersect import INTERSECTORS as INTERSECTORS_T
from hmrt_tpu_torch.traversal.march import march_dda, march_maxmip

torch.set_num_threads(2)  # the suite runs several workers at once

N = 65
N_RAYS = 384
INTERSECTORS = ["triangle", "bilinear", "flat"]
KINDS = ["mixed", "axis"]
#: relative bar on t at a hit, port vs the JAX march. XLA's CPU compiler
#: contracts the intersectors' multiply-adds while torch and the CUDA
#: kernel do not, so t can differ by a few ulps; the bilinear root solve
#: amplifies that. Evaluated op by op, JAX agrees with the port far more
#: tightly (test_intersectors_match_jax_op_by_op). Hit decisions and hit
#: cells are held exact everywhere.
T_RTOL = {"triangle": 1e-5, "flat": 1e-5, "bilinear": 1e-3}


@pytest.fixture(scope="module")
def scenes():
    js = jax_make_scene(procedural_terrain(N, seed=3), pack=False)
    light = {f.name: np.asarray(getattr(js.light, f.name))
             for f in dataclasses.fields(js.light)}
    ts = scene_from_arrays(np.asarray(js.heights), np.asarray(js.pyr_flat), None,
                           light, n=js.n, m=js.m, levels=js.levels, device="cpu")
    return js, ts


def _rays(kind, seed=0):
    o, d = random_rays(N_RAYS, N, seed=seed, kind=kind)
    planes = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]]
    planes = [np.ascontiguousarray(p, np.float32) for p in planes]
    return planes, [torch.from_numpy(p) for p in planes]


def _assert_results(got, want, ci="triangle"):
    """hit, cx, cy exact; t within T_RTOL[ci] relative on hits."""
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.cx.numpy(), np.asarray(want.cx))
    np.testing.assert_array_equal(got.cy.numpy(), np.asarray(want.cy))
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=T_RTOL[ci], atol=0)
    assert hit.any() and not hit.all()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("ci", INTERSECTORS)
@pytest.mark.parametrize("traversal", ["maxmip", "dda"])
def test_march_matches_jax(scenes, kind, ci, traversal):
    js, ts = scenes
    jr, tr = _rays(kind)
    hf = js.heights.reshape(-1)
    if traversal == "maxmip":
        want = jax_march_maxmip(*map(jnp.asarray, jr), js.pyr_flat, hf, n=N,
                                m=js.m, levels=js.levels, max_steps=8 * N + 256,
                                cell_intersect=ci)
        got = march_maxmip(*tr, ts.pyr_flat, ts.heights.reshape(-1), n=N, m=ts.m,
                           levels=ts.levels, max_steps=8 * N + 256,
                           cell_intersect=ci)
    else:
        want = jax_march_dda(*map(jnp.asarray, jr), hf, n=N, max_steps=4 * N,
                             cell_intersect=ci)
        got = march_dda(*tr, ts.heights.reshape(-1), n=N, max_steps=4 * N,
                        cell_intersect=ci)
    _assert_results(got, want, ci)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("ci", ["triangle", "bilinear"])
def test_maxmip_equals_dda(scenes, kind, ci):
    """The accelerated march finds the same cell and t as brute force.
    ("flat" is left out: there the JAX package's own max-mip and DDA
    marches differ on one of these axis rays, and the port matches each
    of them, test_march_matches_jax.)"""
    _, ts = scenes
    _, tr = _rays(kind, seed=1)
    hf = ts.heights.reshape(-1)
    a = march_maxmip(*tr, ts.pyr_flat, hf, n=N, m=ts.m, levels=ts.levels,
                     max_steps=8 * N + 256, cell_intersect=ci)
    b = march_dda(*tr, hf, n=N, max_steps=4 * N, cell_intersect=ci)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.mark.parametrize("ci", INTERSECTORS)
def test_intersectors_match_jax_op_by_op(ci):
    """On the same inputs, the port's intersector equals JAX's evaluated op
    by op (no XLA fusion): hits exactly, t to 2 ulps."""
    rng = np.random.default_rng(7)
    p = 4096
    u = lambda lo, hi: rng.uniform(lo, hi, p).astype(np.float32)  # noqa: E731
    d = rng.normal(size=(p, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    c = np.zeros(p, np.int32)
    args = [u(0, 1), u(0, 1), u(0, 5), *(np.ascontiguousarray(d[:, i]) for i in range(3)),
            c, c, u(0, 3), u(0, 3), u(0, 3), u(0, 3),
            np.full(p, -10, np.float32), np.full(p, 10, np.float32)]
    with jax.disable_jit():
        jh, jt = JAX_INTERSECTORS[ci](*map(jnp.asarray, args))
    th, tt = INTERSECTORS_T[ci](*map(torch.from_numpy, args))
    jh = np.asarray(jh)
    np.testing.assert_array_equal(th.numpy(), jh)
    np.testing.assert_allclose(tt.numpy()[jh], np.asarray(jt)[jh], rtol=2.5e-7, atol=0)
    assert jh.any() and not jh.all()


def test_clip_window_matches_jax(scenes):
    js, ts = scenes
    jr, tr = _rays("mixed", seed=2)
    clip = (8.0, 40.0)
    want = jax_march_maxmip(*map(jnp.asarray, jr), js.pyr_flat,
                            js.heights.reshape(-1), n=N, m=js.m, levels=js.levels,
                            max_steps=8 * N + 256, clip=clip)
    got = march_maxmip(*tr, ts.pyr_flat, ts.heights.reshape(-1), n=N, m=ts.m,
                       levels=ts.levels, max_steps=8 * N + 256, clip=clip)
    _assert_results(got, want)


def _empty_results(p):
    return (torch.zeros(p, dtype=torch.int32), torch.full((p,), 3.0e38),
            torch.zeros(p, dtype=torch.int32), torch.zeros(p, dtype=torch.int32))


def _passes(ts, rays, state, budget, ci, clip=None):
    """Budgeted passes until no ray is alive; returns (state, results)."""
    res = _empty_results(rays[0].shape[0])
    for _ in range(10_000):
        state, res = march_pass_reference(rays, state, res, ts.pyr_flat, ts.heights,
                                          n=ts.n, m=ts.m, levels=ts.levels,
                                          budget=budget, cell_intersect=ci, clip=clip)
        if not state[0].any():
            return state, res
    raise AssertionError("passes did not terminate")


def _refill_march(ts, rays, state, ci, seed, limit):
    """March the rays as the persistent kernels schedule them: again and
    again a random subset of the unfinished rays, in shuffled order, takes a
    chunk of a random number of steps, each ray's total capped at its budget
    `limit` (so a budget can run out in the middle of a chunk), until every
    ray is dead or has used its budget. Returns (state, results)."""
    rng = np.random.default_rng(seed)
    p = rays[0].shape[0]
    st, res = [x.clone() for x in state], list(_empty_results(p))
    used = np.zeros(p, np.int64)
    for _ in range(100_000):
        open_ = np.nonzero((st[0].numpy() != 0) & (used < limit))[0]
        if not open_.size:
            return st, res
        take = rng.permutation(open_)[:int(rng.integers(1, open_.size + 1))]
        steps = np.minimum(int(rng.integers(1, 40)), limit - used[take])
        for b in np.unique(steps):
            idx = torch.from_numpy(take[steps == b])
            s, r = march_pass_reference(
                tuple(x.index_select(0, idx) for x in rays),
                tuple(x.index_select(0, idx) for x in st),
                tuple(x.index_select(0, idx) for x in res), ts.pyr_flat, ts.heights,
                n=ts.n, m=ts.m, levels=ts.levels, budget=int(b), cell_intersect=ci)
            for planes, new in ((st, s), (res, r)):
                for x, y in zip(planes, new):
                    x.index_copy_(0, idx, y)
            used[take[steps == b]] += int(b)  # exact for the rays still alive
    raise AssertionError("the refill march did not terminate")


@pytest.mark.parametrize("ci", INTERSECTORS)
@pytest.mark.parametrize("budget", [1, 7, 64, "refill", "refill-budget-13"])
def test_budgeted_passes_equal_unbudgeted_and_jax(scenes, budget, ci):
    """The per-ray budget invariant the kernel rests on: repeated passes of
    any budget equal one unbudgeted pass, which equals JAX march_maxmip.
    The "refill" cases march as the persistent warps do (random chunks,
    shuffled subsets, random order); with a budget of 13 steps per ray
    they equal one pass of budget 13, in all nine planes, and the JAX march
    capped at 13 steps."""
    js, ts = scenes
    jr, tr = _rays("mixed", seed=3)
    st0 = init_state(tr, None, ts.pyr_flat[-1], n=ts.n, m=ts.m, levels=ts.levels)
    max_steps = 8 * N + 256
    if budget == "refill":
        _, res_b = _refill_march(ts, tr, st0, ci, seed=0, limit=UNBUDGETED)
    elif budget == "refill-budget-13":
        max_steps = 13
        st_b, res_b = _refill_march(ts, tr, st0, ci, seed=1, limit=13)
    else:
        _, res_b = _passes(ts, tr, st0, budget, ci)
    if budget == "refill-budget-13":
        st_u, res_u = march_pass_reference(tr, st0, _empty_results(N_RAYS), ts.pyr_flat,
                                           ts.heights, n=ts.n, m=ts.m, levels=ts.levels,
                                           budget=13, cell_intersect=ci)
        for a, b in zip(st_b, st_u):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert st_u[0].any()  # some rays ran out of budget
    else:
        _, res_u = _passes(ts, tr, st0, UNBUDGETED, ci)
    for a, b in zip(res_b, res_u):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    want = jax_march_maxmip(*map(jnp.asarray, jr), js.pyr_flat,
                            js.heights.reshape(-1), n=N, m=js.m, levels=js.levels,
                            max_steps=max_steps, cell_intersect=ci)
    np.testing.assert_array_equal(res_u[0].numpy() != 0, np.asarray(want.hit))
    np.testing.assert_array_equal(res_u[2].numpy(), np.asarray(want.cx))
    np.testing.assert_array_equal(res_u[3].numpy(), np.asarray(want.cy))
    hit = np.asarray(want.hit)
    np.testing.assert_allclose(res_u[1].numpy()[hit], np.asarray(want.t)[hit],
                               rtol=T_RTOL[ci], atol=0)


def _shadow_rays(ts, tr):
    """Shadow rays from the primary hits of `tr`: origin just above the
    hit point, toward the sun; misses are parked outside the box."""
    hit, t, cx, cy = march_maxmip(*tr, ts.pyr_flat, ts.heights.reshape(-1), n=N,
                                  m=ts.m, levels=ts.levels, max_steps=8 * N + 256)
    ts_ = torch.where(hit, t, 0.0)
    p = [tr[i] + ts_ * tr[i + 3] for i in range(3)]
    sun = ts.light.sun_dir
    o = [p[i] + sun[i] * 1e-2 + lift for i, lift in enumerate((0.0, 0.0, 1e-2))]
    o[0] = torch.where(hit, o[0], -1e6)
    o[1] = torch.where(hit, o[1], -1e6)
    d = [sun[i].expand(hit.shape[0]).contiguous() for i in range(3)]
    return tuple(o + d), hit, cx, cy


def test_shadow_start_cell_matches_jax(scenes):
    """The compact shadow march starts at level 0 in the hit cell: its
    initial state equals the JAX package's, and its occlusion equals the
    JAX march from the pyramid top on the same rays."""
    js, ts = scenes
    _, tr = _rays("mixed", seed=4)
    srays, hit, cx, cy = _shadow_rays(ts, tr)
    st0 = init_state(srays, hit, ts.pyr_flat[-1], n=ts.n, m=ts.m,
                     levels=ts.levels, start_cell=(cx, cy))
    jst0 = jax_init_state(*[jnp.asarray(r.numpy()) for r in srays],
                          jnp.asarray(hit.numpy()), js.pyr_flat[-1], n=js.n,
                          levels=js.levels, m=js.m,
                          start_cell=(jnp.asarray(cx.numpy()), jnp.asarray(cy.numpy())))
    for a, b in zip(st0, jst0):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _, res = _passes(ts, srays, st0, 7, "triangle")
    want = jax_march_maxmip(*[jnp.asarray(r.numpy()) for r in srays], js.pyr_flat,
                            js.heights.reshape(-1), n=N, m=js.m, levels=js.levels,
                            max_steps=8 * N + 256)
    np.testing.assert_array_equal(res[0].numpy() != 0, np.asarray(want.hit))
    assert hit.any()


def test_march_pass_cpu_uses_plain_version(scenes):
    """On CPU tensors the wrapper runs the plain version: equal results, no
    kernel launch counted."""
    _, ts = scenes
    _, tr = _rays("axis", seed=5)
    st0 = init_state(tr, None, ts.pyr_flat[-1], n=ts.n, m=ts.m, levels=ts.levels)
    res0 = _empty_results(N_RAYS)
    before = march_pass.launches
    kw = dict(n=ts.n, m=ts.m, levels=ts.levels, budget=9)
    a = march_pass(tr, st0, res0, ts.pyr_flat, ts.heights, ts.corners, **kw)
    b = march_pass_reference(tr, st0, res0, ts.pyr_flat, ts.heights, **kw)
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert march_pass.launches == before
