"""The CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA device and skips without one (there is no
interpret mode for a CUDA kernel). On a machine with a card:
    python -m pytest tests/test_torch_kernels_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

import hmrt_tpu_torch as T
from conftest import random_rays
from hmrt_tpu_torch.kernels import _build
from hmrt_tpu_torch.kernels.compact import force_level0, init_state, render_frame_compact
from hmrt_tpu_torch.core.renderer import render_frame_oracle
from hmrt_tpu_torch.kernels.march_pass import (UNBUDGETED, march_pass,
                                               march_pass_reference)
from hmrt_tpu_torch.kernels.raycast import (fused_planes, fused_reference_planes,
                                            render_frame_fused,
                                            render_frame_fused_reference)
from hmrt_tpu_torch.kernels.shade_pass import shade_pass, shade_pass_reference
from hmrt_tpu_torch.traversal.intersect import INTERSECTORS
from hmrt_tpu_torch.traversal.march import (WorkCounter, l0_step, ray_box_range, ray_inverses,
                                            record_corners, run_masked)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _scene(n, dev):
    return T.make_scene(T.procedural_terrain(n, seed=3), device=dev)


def _rays(n, dev, p=8192, seed=0):
    o, d = random_rays(p, n, seed=seed)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
                 for a in (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]))


def _empty_results(p, dev):
    return (torch.zeros(p, dtype=torch.int32, device=dev),
            torch.full((p,), 3.0e38, device=dev),
            torch.zeros(p, dtype=torch.int32, device=dev),
            torch.zeros(p, dtype=torch.int32, device=dev))


def _ran_group():
    """The lanes a ray of the level-0 tail the last launches ran (the tally):
    the plain version of that walk takes the same group."""
    ran = {k for k, v in march_pass.mode_launches.read().items() if v}
    return 32 if "l0_g32" in ran else 1


def _old_walk_hits(sc, rays, st, res, ci="triangle"):
    """The old level-0 walk (`l0_step` over every cell, no min pyramid) to
    the end: (hit, t_hit, hx, hy), which every form of the tail must give."""
    ox, oy, oz, dx, dy, dz = rays
    inv_x, inv_y = ray_inverses(dx, dy)
    _, t1, _ = ray_box_range(ox, oy, dx, dy, float(sc.n - 1))
    ray = (ox, oy, oz, dx, dy, dz, inv_x, inv_y, t1)
    corners = record_corners(sc.heights.reshape(-1), sc.n, sc.m)
    out = run_masked(lambda s: l0_step(ray, s, corners, sc.pyr_flat[-1], m=sc.m,
                                       intersector=INTERSECTORS[ci]),
                     dict(t=st[1], lvl=st[2], icx=st[3], icy=st[4], alive=st[0] != 0,
                          hit=res[0] != 0, t_hit=res[1], hx=res[2], hy=res[3]), UNBUDGETED)
    return out["hit"].to(torch.int32), out["t_hit"], out["hx"], out["hy"]


@pytest.mark.parametrize("ci", ["triangle", "bilinear", "flat"])
@pytest.mark.parametrize("budget", [1, 7, 37, 64, UNBUDGETED])
@pytest.mark.parametrize("n", [128, 1024])
def test_march_kernel_equals_plain(cuda, n, budget, ci):
    """All 9 output planes equal, bit for bit, from the initial state and
    from a mid-march state (budget 37 ends rays in the middle of the
    kernel's second chunk)."""
    sc = _scene(n, cuda)
    rays = _rays(n, cuda)
    st = init_state(rays, None, sc.pyr_flat[-1], n=sc.n, m=sc.m, levels=sc.levels)
    res = _empty_results(rays[0].shape[0], cuda)
    kw = dict(n=sc.n, m=sc.m, levels=sc.levels, cell_intersect=ci)
    for _ in range(2):
        sk, rk = march_pass(rays, st, res, sc.pyr_flat, sc.heights, sc.corners, budget=budget,
                            **kw)
        torch.cuda.synchronize()
        sr, rr = march_pass_reference(rays, st, res, sc.pyr_flat, sc.heights,
                                      budget=budget, **kw)
        for a, b in zip(sk + rk, sr + rr):
            assert torch.equal(a, b)
        st, res = sk, rk


def _grazing_rays(n, dev, p=4096, seed=0):
    """Near-horizontal rays from just outside the y=0 edge: the rays that
    end in the level-0 tail."""
    rng = np.random.default_rng(seed)
    hmax = float(T.procedural_terrain(n, seed=3).max())
    o = np.stack([rng.uniform(0, n - 1, p), np.full(p, -0.5),
                  rng.uniform(0.3 * hmax, 1.1 * hmax, p)], -1)
    d = np.stack([rng.uniform(-0.3, 0.3, p), np.ones(p), rng.uniform(-0.05, 0.02, p)], -1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
                 for a in (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]))


@pytest.mark.parametrize("mode", ["l0", "l0-g1", "l0-g32", 4, 8, 16, "auto-l0", "auto-maxmip",
                                  "auto-relax"])
@pytest.mark.parametrize("ci", ["triangle", "bilinear", "flat"])
def test_march_kernel_tail_modes_equal_plain(cuda, ci, mode):
    """K1's level-0 tail (l0_only; its group chosen on the card, or forced
    to one lane or 32 lanes a ray) and relaxed tail (relax=k), and both
    under a device flag, equal their plain versions (the level-0 tail's of
    the group the launch ran) in all 9 planes and in the counting
    instance's per-ray counts, from the state a budgeted max-mip pass and
    force_level0 leave, on mixed and grazing rays (many of them under the
    terrain); the level-0 tail's hits are the old walk's; the tally
    records the march each launch ran."""
    n = 1024
    sc = _scene(n, cuda)
    rays = tuple(torch.cat([a, b]) for a, b in zip(_rays(n, cuda), _grazing_rays(n, cuda)))
    p = rays[0].shape[0]
    st = init_state(rays, None, sc.pyr_flat[-1], n=sc.n, m=sc.m, levels=sc.levels)
    kw = dict(n=sc.n, m=sc.m, levels=sc.levels, cell_intersect=ci)
    st, res = march_pass(rays, st, _empty_results(p, cuda), sc.pyr_flat, sc.heights,
                         sc.corners, budget=64, **kw)
    st = force_level0(rays, st)
    l0_only = {"auto-l0": torch.tensor(True, device=cuda),
               "auto-relax": torch.tensor(True, device=cuda),
               "auto-maxmip": torch.tensor(False, device=cuda)}.get(mode, True)
    relax = mode if isinstance(mode, int) else 8 if mode == "auto-relax" else 0
    group = int(mode[4:]) if isinstance(mode, str) and mode.startswith("l0-g") else "auto"
    cnt = torch.empty((2, p), dtype=torch.int32, device=cuda)
    before = march_pass.launches
    march_pass.mode_launches.reset()
    sk, rk = march_pass(rays, st, res, sc.pyr_flat, sc.heights, sc.corners,
                        budget=UNBUDGETED, counts=cnt, l0_only=l0_only, relax=relax, group=group,
                        pyr_min=sc.pyr_min_flat, **kw)
    torch.cuda.synchronize()
    assert march_pass.launches == before + 1
    ran = {k: v for k, v in march_pass.mode_launches.read().items() if v}
    want = ({"relax"} if relax else {"maxmip"} if mode == "auto-maxmip"
            else {"l0"} if group == "auto"
            else {{1: "l0", 32: "l0_g32"}[group]})
    assert len(ran) == 1 and set(ran) <= want and sum(ran.values()) == 1, ran
    work = WorkCounter(sc.pyr_flat.shape[0], sc.n, cuda, lanes=p)
    sr, rr = march_pass_reference(rays, st, res, sc.pyr_flat, sc.heights, budget=UNBUDGETED,
                                  counter=work, l0_only=l0_only, relax=relax,
                                  group="auto" if relax else _ran_group(), **kw)
    for a, b in zip(sk + rk, sr + rr):
        assert torch.equal(a, b)
    assert torch.equal(cnt[0], work.lane_steps) and torch.equal(cnt[1], work.lane_tests)
    assert int(st[0].sum()) > 0 and not sk[0].any()
    if not relax and mode != "auto-maxmip":
        for a, b in zip(rk, _old_walk_hits(sc, rays, st, res, ci)):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unbudgeted"):
        march_pass(rays, st, res, sc.pyr_flat, sc.heights, sc.corners, budget=64,
                   l0_only=True, relax=4, pyr_min=sc.pyr_min_flat, **kw)


@pytest.mark.parametrize("l0_tail", [True, "auto"])
def test_compact_tails_on_card(cuda, l0_tail):
    """On the card, render_frame_compact with the level-0 tail (relax=0)
    equals the frame without it in every buffer, and its hits are the torch
    oracle's; the relaxed tail (stride 8) has no false hits and differs on at
    most 2% of the hits."""
    terr = T.procedural_terrain(257, seed=3)
    cfg = T.RenderConfig(width=160, height=64, shading="phong", shadows=True,
                         aux_buffers=True)
    sc = T.make_scene(terr, device=cuda)
    cam = T.Camera.create(eye=(128, -40, float(terr.max()) + 4), target=(128, 128, 10),
                          device=cuda)
    kw = dict(first_budget=8, round_budget=16)
    base = render_frame_compact(sc, cam, cfg, l0_tail=False, **kw)
    exact = render_frame_compact(sc, cam, cfg, l0_tail=l0_tail, **kw)
    for f in ("hit", "depth", "normal", "color"):
        assert torch.equal(getattr(exact, f), getattr(base, f)), f
    assert torch.equal(exact.hit, render_frame_oracle(sc, cam, cfg).hit)
    relaxed = render_frame_compact(sc, cam, cfg, l0_tail=l0_tail, relax=8, **kw)
    assert not (relaxed.hit & ~exact.hit).any()
    assert int((relaxed.hit != exact.hit).sum()) <= 0.02 * int(exact.hit.sum())
    assert exact.hit.any()


#: K1's marches: max-mip, and the level-0 tail at one lane or 32 lanes a
#: ray, or "auto" (one lane a ray)
MARCHES = ["maxmip", 1, 32, "auto"]


def _march_kw(march, rays, st, sc):
    """(state, march_pass keywords) of a march of MARCHES: the level-0 tail
    starts from force_level0 of the state and reads the min pyramid."""
    if march == "maxmip":
        return st, {}
    return force_level0(rays, st), dict(l0_only=True, group=march, pyr_min=sc.pyr_min_flat)


@pytest.mark.parametrize("march", MARCHES)
@pytest.mark.parametrize("p", [0, 1, 16, 31, 33, 4097, 300_000])
def test_march_kernel_equals_plain_at_ray_counts(cuda, p, march):
    """The persistent kernel on no ray, one ray, a warp and a lane, less
    than a warp, and more rays than one resident wave of the card holds
    (132 SMs x 2,048 threads is 270,336), in every march: all 9 planes and
    the counting instance's per-ray counts equal the plain version's (the
    level-0 tail's of the group the tally says the launch ran),
    unbudgeted and at a budget that ends rays inside a chunk and a window;
    the level-0 tail's hits are the old walk's."""
    sc = _scene(128, cuda)
    rays = _rays(128, cuda, p=max(p, 1), seed=5)
    rays = tuple(x[:p].contiguous() for x in rays)
    st = init_state(rays, None, sc.pyr_flat[-1], n=sc.n, m=sc.m, levels=sc.levels)
    st, tail = _march_kw(march, rays, st, sc)
    res = _empty_results(p, cuda)
    kw = dict(n=sc.n, m=sc.m, levels=sc.levels)
    for budget in (37, UNBUDGETED):
        before = march_pass.launches
        cnt = torch.empty((2, p), dtype=torch.int32, device=cuda)
        march_pass.mode_launches.reset()
        sk, rk = march_pass(rays, st, res, sc.pyr_flat, sc.heights, sc.corners,
                            budget=budget, counts=cnt, **kw, **tail)
        torch.cuda.synchronize()
        assert march_pass.launches == before + (1 if p else 0)
        ran = {k for k, v in march_pass.mode_launches.read().items() if v}
        want_ran = ({"maxmip"} if not tail else {"l0"} if march == "auto"
                    else {{1: "l0", 32: "l0_g32"}[march]})
        assert (ran <= want_ran and len(ran) == 1) if p else not ran, ran
        work = WorkCounter(sc.pyr_flat.shape[0], sc.n, cuda, lanes=p)
        sr, rr = march_pass_reference(rays, st, res, sc.pyr_flat, sc.heights,
                                      budget=budget, counter=work, **kw, l0_only=bool(tail),
                                      group=_ran_group() if tail else "auto")
        for a, b in zip(sk + rk, sr + rr):
            assert torch.equal(a, b)
        assert torch.equal(cnt[0], work.lane_steps) and torch.equal(cnt[1], work.lane_tests)
    if tail:
        for a, b in zip(rk, _old_walk_hits(sc, rays, st, res)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("march", MARCHES[:-1])
@pytest.mark.parametrize("budget", [37, UNBUDGETED])
def test_march_kernel_counts_equal_work_counter(cuda, budget, march):
    """The counting instance, in every march: per-ray steps and cell tests
    equal the plain version's per-lane counts, and the planes equal the
    timed instance's."""
    sc = _scene(1024, cuda)
    rays = _rays(1024, cuda, p=20_000, seed=6)
    st = init_state(rays, None, sc.pyr_flat[-1], n=sc.n, m=sc.m, levels=sc.levels)
    st, tail = _march_kw(march, rays, st, sc)
    res = _empty_results(20_000, cuda)
    kw = dict(n=sc.n, m=sc.m, levels=sc.levels, budget=budget)
    counts = torch.full((2, 20_000), -1, dtype=torch.int32, device=cuda)
    got = march_pass(rays, st, res, sc.pyr_flat, sc.heights, sc.corners, counts=counts, **kw,
                     **tail)
    timed = march_pass(rays, st, res, sc.pyr_flat, sc.heights, sc.corners, **kw, **tail)
    torch.cuda.synchronize()
    work = WorkCounter(sc.pyr_flat.shape[0], sc.n, cuda, lanes=20_000)
    march_pass_reference(rays, st, res, sc.pyr_flat, sc.heights, counter=work, **kw,
                         l0_only=bool(tail), group=tail.get("group", "auto"))
    for a, b in zip(got[0] + got[1], timed[0] + timed[1]):
        assert torch.equal(a, b)
    assert torch.equal(counts[0], work.lane_steps) and torch.equal(counts[1], work.lane_tests)
    assert int(counts[0].sum()) == int(work.steps) and int(counts[1].sum()) == int(work.tests)


@pytest.mark.parametrize("group", ["auto", 32])
@pytest.mark.parametrize("live", [0, 16, 5000])
def test_march_kernel_wide_tail_launch_equals_plain(cuda, live, group):
    """A tail launch shaped as the main path makes it: many lanes, few of
    them live (B4's is 921,600 lanes with 16 live), marched one lane a ray
    ("auto") or 32 lanes a ray. All 9 planes and the per-ray counts equal
    the plain version of that march on the live lanes, the dead lanes come
    out as they came with 0 steps, and the tally names the march."""
    sc = _scene(1024, cuda)
    p = 300_000
    rays = _rays(1024, cuda, p=p, seed=9)
    st = init_state(rays, None, sc.pyr_flat[-1], n=sc.n, m=sc.m, levels=sc.levels)
    st, res = march_pass(rays, st, _empty_results(p, cuda), sc.pyr_flat, sc.heights,
                         sc.corners, n=sc.n, m=sc.m, levels=sc.levels, budget=24)
    keep = torch.zeros(p, dtype=torch.bool, device=cuda)
    keep[torch.nonzero(st[0] != 0).squeeze(1)[:live]] = True
    st = force_level0(rays, (torch.where(keep, st[0], 0),) + st[1:])
    assert int(st[0].sum()) == live
    kw = dict(n=sc.n, m=sc.m, levels=sc.levels, budget=UNBUDGETED, l0_only=True,
              group=group, pyr_min=sc.pyr_min_flat)
    cnt = torch.empty((2, p), dtype=torch.int32, device=cuda)
    march_pass.mode_launches.reset()
    sk, rk = march_pass(rays, st, res, sc.pyr_flat, sc.heights, sc.corners, counts=cnt, **kw)
    ran = {k for k, v in march_pass.mode_launches.read().items() if v}
    assert ran == ({"l0_g32"} if group == 32 else {"l0"}), ran
    work = WorkCounter(sc.pyr_flat.shape[0], sc.n, cuda, lanes=p)
    sr, rr = march_pass_reference(rays, st, res, sc.pyr_flat, sc.heights, counter=work, **kw)
    for a, b in zip(sk + rk, sr + rr):
        assert torch.equal(a, b)
    assert torch.equal(cnt[0], work.lane_steps) and torch.equal(cnt[1], work.lane_tests)


def test_march_kernel_tail_needs_min_pyramid(cuda):
    """On the card the exact level-0 tail reads the scene's min pyramid: a
    pass that may run it (l0_only, or the "auto" flag) raises without one,
    or with one of another shape, before anything launches; the max-mip
    pass and the relaxed tail need none."""
    sc = _scene(128, cuda)
    rays = _rays(128, cuda, p=64, seed=2)
    st = force_level0(rays, init_state(rays, None, sc.pyr_flat[-1], n=sc.n, m=sc.m,
                                       levels=sc.levels))
    res = _empty_results(64, cuda)
    kw = dict(n=sc.n, m=sc.m, levels=sc.levels, budget=UNBUDGETED)
    args = (rays, st, res, sc.pyr_flat, sc.heights, sc.corners)
    before = march_pass.launches
    for flag in (True, torch.tensor(False, device=cuda)):
        with pytest.raises(ValueError, match="min pyramid"):
            march_pass(*args, l0_only=flag, **kw)
        with pytest.raises(ValueError, match="pyr_min"):
            march_pass(*args, l0_only=flag, pyr_min=sc.pyr_min_flat[1:], **kw)
    assert march_pass.launches == before
    march_pass(*args, **kw)
    march_pass(*args, l0_only=True, relax=4, **kw)
    assert march_pass.launches == before + 2


@pytest.mark.parametrize("ci", ["triangle", "bilinear", "flat"])
def test_latency_probe_equals_plain_walk(cuda, ci):
    """The latency probe (csrc/l0_probe.cu) walks a ray's level-0 DDA as the
    plain walk does on the card, past the march's end (a hit cell taken
    again, records clamped past the edge): the same t, t_hit, cell, hit
    and cell tests, and the wrapper counts each launch."""
    from hmrt_tpu_torch.bench.latency import l0_walk, l0_walk_reference
    sc = _scene(128, cuda)
    rays = tuple(torch.cat([a, b]) for a, b in zip(_rays(128, cuda, p=64, seed=3),
                                                   _grazing_rays(128, cuda, p=64)))
    st = force_level0(rays, init_state(rays, None, sc.pyr_flat[-1], n=sc.n, m=sc.m,
                                       levels=sc.levels))
    for k in range(0, 128, 9):
        one_r = tuple(x[k:k + 1].contiguous() for x in rays)
        one_s = tuple(x[k:k + 1].contiguous() for x in st)
        for steps in (0, 1, 40, 300):
            before = l0_walk.launches
            got = l0_walk(one_r, one_s, sc, steps=steps, cell_intersect=ci)
            assert l0_walk.launches == before + 1
            want = l0_walk_reference(one_r, one_s, sc, steps=steps, cell_intersect=ci)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (k, steps)


@pytest.mark.parametrize("bad", ["shape", "dtype", "strided", "misaligned"])
def test_kernels_reject_bad_record_plane(cuda, bad):
    """Both wrappers raise on a record plane the kernels cannot read as
    float4 records, before any launch."""
    sc = _scene(128, cuda)
    m = sc.m
    planes = {"shape": torch.zeros((m, m, 3), device=cuda),
              "dtype": sc.corners.double(),
              "strided": torch.zeros((m, m, 8), device=cuda)[..., :4],
              "misaligned": torch.zeros(m * m * 4 + 1, device=cuda)[1:].view(m, m, 4)}
    rays = _rays(128, cuda, p=256)
    st = init_state(rays, None, sc.pyr_flat[-1], n=sc.n, m=sc.m, levels=sc.levels)
    m0, f0 = march_pass.launches, render_frame_fused.launches
    with pytest.raises(ValueError, match="corners"):
        march_pass(rays, st, _empty_results(256, cuda), sc.pyr_flat, sc.heights,
                   planes[bad], n=sc.n, m=sc.m, levels=sc.levels, budget=UNBUDGETED)
    cam = T.Camera.create(eye=(64.0, -40.0, 60.0), target=(64.0, 64.0, 5.0), device=cuda)
    with pytest.raises(ValueError, match="corners"):
        fused_planes(dataclasses.replace(sc, corners=planes[bad]), cam,
                     T.RenderConfig(width=32, height=8))
    assert (march_pass.launches, render_frame_fused.launches) == (m0, f0)


def _assert_shade_equal(lanes, sc, textured):
    """K2 on the scene's records equals its plain version bit for bit."""
    alb = sc.albedo_rec if textured else None
    got = shade_pass(*lanes, sc.shade_rec, alb)
    torch.cuda.synchronize()
    want = shade_pass_reference(*lanes, sc.shade_rec, alb)
    for a, b in zip(got, want):
        assert torch.equal(a, b), float((a - b).abs().max())
    return got


def _shade_scene(n, textured, dev, seed=1):
    albedo = (np.random.default_rng(seed).uniform(0, 1, (n, n, 3)).astype(np.float32)
              if textured else None)
    return T.make_scene(T.procedural_terrain(n, seed=3), albedo=albedo, device=dev)


@pytest.mark.parametrize("textured", [False, True])
@pytest.mark.parametrize("n", [128, 1024])
def test_shade_kernel_equals_plain(cuda, n, textured):
    """Exactly: the same record values through the same expressions."""
    rng = np.random.default_rng(1)
    sc = _shade_scene(n, textured, cuda)
    p = 65536
    lanes = [torch.from_numpy(a).to(cuda) for a in (
        (rng.uniform(size=p) < 0.7).astype(np.int32),
        rng.integers(0, n - 1, p).astype(np.int32),
        rng.integers(0, n - 1, p).astype(np.int32),
        rng.uniform(0, 1, p).astype(np.float32), rng.uniform(0, 1, p).astype(np.float32))]
    _assert_shade_equal(lanes, sc, textured)


@pytest.mark.parametrize("textured", [False, True])
@pytest.mark.parametrize("case", ["last_row_col", "out_of_range", "all_miss", "ragged"])
def test_shade_kernel_edges_equal_plain(cuda, textured, case):
    """Lanes on the last cell row and column, hit cells outside the grid
    (clamped), all-miss lane sets, and lane counts that end inside a block."""
    n = 129
    c = n - 1
    sc = _shade_scene(n, textured, cuda)
    rng = np.random.default_rng(7)
    p = {"last_row_col": 4096, "out_of_range": 4096, "all_miss": 3000, "ragged": 257}[case]
    hx = rng.integers(0, c, p)
    hy = rng.integers(0, c, p)
    hit = np.ones(p, np.int32)
    if case == "last_row_col":
        hx[::2], hy[1::2] = c - 1, c - 1
    elif case == "out_of_range":
        hx = rng.integers(-5 * c, 5 * c, p)
        hy = rng.integers(-5 * c, 5 * c, p)
    elif case == "all_miss":
        hit[:] = 0
    lanes = [torch.from_numpy(a).to(cuda) for a in (
        hit, hx.astype(np.int32), hy.astype(np.int32),
        rng.uniform(0, 1, p).astype(np.float32), rng.uniform(0, 1, p).astype(np.float32))]
    got = _assert_shade_equal(lanes, sc, textured)
    if case == "all_miss":
        for x, v in zip(got, (0.0, 0.0, 1.0, 0.55, 0.55, 0.55)):
            assert bool((x == float(np.float32(v))).all())
    if case == "out_of_range":   # a clamped lane reads the cell it clamps to
        cl = [lanes[0], lanes[1].clamp(0, c - 1), lanes[2].clamp(0, c - 1), *lanes[3:]]
        for a, b in zip(got, shade_pass(*cl, sc.shade_rec, sc.albedo_rec if textured else None)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["shape", "misaligned", "albedo_dtype", "albedo_shape"])
def test_shade_kernel_rejects_bad_records(cuda, bad):
    """The wrapper raises before any launch on records the kernel cannot
    read as float4 loads."""
    sc = _shade_scene(128, True, cuda)
    c = sc.n - 1
    args = {"shape": (torch.zeros((c, c, 4), device=cuda), None),
            "misaligned": (torch.zeros(c * c * 8 + 1, device=cuda)[1:].view(c, c, 8), None),
            "albedo_dtype": (sc.shade_rec, sc.albedo_rec.double()),
            "albedo_shape": (sc.shade_rec, sc.albedo_rec[1:])}[bad]
    lanes = [torch.zeros(64, dtype=torch.int32, device=cuda) for _ in range(3)]
    lanes += [torch.zeros(64, device=cuda) for _ in range(2)]
    before = shade_pass.launches
    with pytest.raises(ValueError, match="rec"):
        shade_pass(*lanes, *args)
    assert shade_pass.launches == before


@pytest.mark.parametrize("ci", ["triangle", "bilinear", "flat"])
def test_march_kernel_clip_window_equals_plain(cuda, ci):
    sc = _scene(128, cuda)
    rays = _rays(128, cuda, seed=2)
    clip = (8.0, 100.0)
    st = init_state(rays, None, sc.pyr_flat[-1], n=sc.n, m=sc.m, levels=sc.levels,
                    clip=clip)
    res = _empty_results(rays[0].shape[0], cuda)
    kw = dict(n=sc.n, m=sc.m, levels=sc.levels, cell_intersect=ci, clip=clip,
              budget=UNBUDGETED)
    got = march_pass(rays, st, res, sc.pyr_flat, sc.heights, sc.corners, **kw)
    torch.cuda.synchronize()
    want = march_pass_reference(rays, st, res, sc.pyr_flat, sc.heights, **kw)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b)


def test_march_kernel_rejects_bad_levels(cuda):
    sc = _scene(128, cuda)
    rays = _rays(128, cuda, p=1024)
    st = list(init_state(rays, None, sc.pyr_flat[-1], n=sc.n, m=sc.m, levels=sc.levels))
    st[2] = torch.full_like(st[2], sc.levels)
    with pytest.raises(ValueError, match="levels"):
        march_pass(rays, tuple(st), _empty_results(1024, cuda), sc.pyr_flat, sc.heights,
                   sc.corners, n=sc.n, m=sc.m, levels=sc.levels, budget=1)


CAMERAS = {
    "default": dict(eye=(64.0, -42.0, 50.0), target=(64.0, 64.0, 5.0)),
    "grazing": dict(eye=(-10.0, 64.0, 14.0), target=(128.0, 65.0, 13.5)),
    "under": dict(eye=(64.0, 64.0, -2.0), target=(115.0, 90.0, -1.0)),
    "sky": dict(eye=(64.0, -64.0, 40.0), target=(64.0, -256.0, 80.0)),
}
CONFIGS = {
    "phong_shadows": dict(shading="phong", shadows=True),
    "texture_fog": dict(texture=True, fog=True, shading="phong"),
    "bilinear": dict(cell_intersect="bilinear", shadows=True),
}


@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("cam", list(CAMERAS))
@pytest.mark.parametrize("backend", ["compact", "pallas"])
def test_frames_match_oracle_on_card(cuda, backend, cam, cfg):
    """render_frame on the card (the kernels of either path) against the
    torch oracle on the card: hit mask equal, colour < 5e-5, depth and
    normal as on the CPU (tests/test_torch_render.py)."""
    terr = T.procedural_terrain(128, seed=3)
    albedo = np.random.default_rng(0).uniform(0.2, 0.9, (128, 128, 3)).astype(np.float32)
    sc = T.make_scene(terr, albedo=albedo, device=cuda)
    c = T.Camera.create(**CAMERAS[cam], device=cuda)
    rc = T.RenderConfig(width=128, height=64, aux_buffers=True, backend=backend,
                        **CONFIGS[cfg])
    fc = T.render_frame(sc, c, rc)
    fo = render_frame_oracle(sc, c, rc)
    assert torch.equal(fc.hit, fo.hit)
    assert float((fc.color - fo.color).abs().max()) < 5e-5
    h = fo.hit
    torch.testing.assert_close(fc.depth[h], fo.depth[h], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(fc.normal[h], fo.normal[h], rtol=0, atol=1e-4)


def test_launch_counters_rise_and_frame_matches_oracle(cuda):
    sc = _scene(128, cuda)
    cam = T.Camera.create(eye=(64.0, -40.0, 60.0), target=(64.0, 64.0, 5.0), device=cuda)
    cfg = T.RenderConfig(width=128, height=64, shading="phong", shadows=True,
                         aux_buffers=True, backend="compact")
    m0, s0 = march_pass.launches, shade_pass.launches
    fc = T.render_frame(sc, cam, cfg)
    assert march_pass.launches > m0 and shade_pass.launches > s0
    fo = render_frame_oracle(sc, cam, cfg)
    assert torch.equal(fc.hit, fo.hit)
    assert float((fc.color - fo.color).abs().max()) < 5e-5
    # the schedule does not change the frame
    fs = render_frame_compact(sc, cam, cfg, first_budget=3, rounds=3, round_budget=5)
    assert torch.equal(fs.color, fc.color)


FUSED_CASES = {
    "lambert": dict(),
    "phong_shadows": dict(shading="phong", shadows=True),
    "fog": dict(fog=True, shading="phong"),
    "texture": dict(texture=True),
    "aux": dict(aux_buffers=True, shadows=True),
    "odd_resolution": dict(width=100, height=37, shadows=True, aux_buffers=True),
    "ragged_patches": dict(width=67, height=5, shading="phong", shadows=True,
                           aux_buffers=True),
    "one_pixel": dict(width=1, height=1, shadows=True, aux_buffers=True),
    "bilinear": dict(cell_intersect="bilinear", shadows=True, aux_buffers=True),
    "clip": dict(clip_box=(8.0, 50.0), shadows=True, aux_buffers=True),
}


def _fused_scene(n, dev):
    terr = T.procedural_terrain(n, seed=3)
    albedo = np.random.default_rng(0).uniform(0.2, 0.9, (n, n, 3)).astype(np.float32)
    sc = T.make_scene(terr, albedo=albedo, device=dev)
    cam = T.Camera.create(eye=(n * 0.5, -n * 0.3, float(terr.max()) + n * 0.08),
                          target=(n * 0.5, n * 0.5, float(terr.mean())), device=dev)
    return sc, cam


def _assert_fused_equal(got, want, aux):
    """Kernel planes against the plain version's: hit, depth and hit cells
    equal, colour and normals within 1e-6."""
    color, depth, normal, hit, cell = got
    assert torch.equal(hit.reshape(-1), want[3])
    assert torch.equal(cell.reshape(-1, 2), want[4])
    assert float((color.reshape(-1, 3) - want[0]).abs().max()) <= 1e-6
    if aux:
        assert torch.equal(depth.reshape(-1), want[1])
        assert float((normal.reshape(-1, 3) - want[2]).abs().max()) <= 1e-6


@pytest.mark.parametrize("case", list(FUSED_CASES))
@pytest.mark.parametrize("n", [65, 128])
def test_fused_kernel_equals_plain(cuda, n, case):
    sc, cam = _fused_scene(n, cuda)
    cfg = T.RenderConfig(**dict(dict(width=128, height=64), **FUSED_CASES[case]))
    before = render_frame_fused.launches
    got = fused_planes(sc, cam, cfg, cells=True)
    torch.cuda.synchronize()
    assert render_frame_fused.launches == before + 1
    _assert_fused_equal(got, fused_reference_planes(sc, cam, cfg), cfg.aux_buffers)


@pytest.mark.parametrize("shadows", [False, True])
def test_fused_kernel_counts_equal_work_counter(cuda, shadows):
    """The counting instance of the fused kernel: per pixel, the primary and
    the shadow march's steps and cell tests equal the plain version's
    per-lane counts (on a frame whose H and W are not multiples of the
    8 x 4 patch), and the planes equal the timed instance's."""
    sc, cam = _fused_scene(128, cuda)
    cfg = T.RenderConfig(width=101, height=46, shading="phong", shadows=shadows,
                         aux_buffers=True)
    counts = torch.full((4, 46, 101), -1, dtype=torch.int32, device=cuda)
    got = fused_planes(sc, cam, cfg, cells=True, counts=counts)
    timed = fused_planes(sc, cam, cfg, cells=True)
    torch.cuda.synchronize()
    for a, b in zip(got, timed):
        assert torch.equal(a, b)
    works = [WorkCounter(sc.pyr_flat.shape[0], sc.n, cuda, lanes=46 * 101) for _ in range(2)]
    want = fused_reference_planes(sc, cam, cfg, counter=works[0], shadow_counter=works[1])
    _assert_fused_equal(got, want, True)
    for k, lane in enumerate(x for w in works for x in (w.lane_steps, w.lane_tests)):
        assert torch.equal(counts[k].reshape(-1), lane)


@pytest.mark.parametrize("n", [65, 128])
def test_fused_kernel_row_bands_equal_plain(cuda, n):
    """4 bands of a 64-row screen, each equal to the plain version of the
    same band and, stitched, to the kernel's whole frame."""
    sc, cam = _fused_scene(n, cuda)
    cfg = T.RenderConfig(width=96, height=16, shading="phong", shadows=True,
                         aux_buffers=True)
    whole = fused_planes(sc, cam, dataclasses.replace(cfg, height=64), cells=True)
    bands = []
    for k in range(4):
        got = fused_planes(sc, cam, cfg, row0=16 * k, full_height=64, cells=True)
        torch.cuda.synchronize()
        _assert_fused_equal(got, fused_reference_planes(sc, cam, cfg, row0=16 * k,
                                                        full_height=64), True)
        bands.append(got)
    for f in range(5):
        assert torch.equal(torch.cat([b[f] for b in bands]), whole[f])


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_fused_frame_equals_compact_frame(cuda, cfg):
    """The two kernel paths on the card: hit mask and depth equal bit for
    bit (one march code), colour and normals within 1e-6."""
    sc, cam = _fused_scene(128, cuda)
    rc = T.RenderConfig(width=128, height=64, aux_buffers=True, **CONFIGS[cfg])
    ff = T.render_frame(sc, cam, dataclasses.replace(rc, backend="pallas"))
    fc = T.render_frame(sc, cam, dataclasses.replace(rc, backend="compact"))
    assert torch.equal(ff.hit, fc.hit)
    assert torch.equal(ff.depth, fc.depth)
    assert float((ff.color - fc.color).abs().max()) <= 1e-6
    assert float((ff.normal - fc.normal).abs().max()) <= 1e-6


def test_auto_routes_small_maps_to_fused(cuda):
    sc, cam = _fused_scene(128, cuda)
    m0, f0 = march_pass.launches, render_frame_fused.launches
    T.render_frame(sc, cam, T.RenderConfig(width=64, height=32))
    assert render_frame_fused.launches == f0 + 1 and march_pass.launches == m0


def test_unbuildable_library_raises(cuda, tmp_path, monkeypatch):
    """A CUDA tensor given to a wrapper whose kernels cannot be built
    raises; it never falls back to the plain version."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "broken.cu").write_text("this is not CUDA C++\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.library.cache_clear()
    try:
        sc = _scene(128, cuda)
        lanes = [torch.zeros(1024, dtype=torch.int32, device=cuda) for _ in range(3)]
        lanes += [torch.zeros(1024, device=cuda) for _ in range(2)]
        before = shade_pass.launches
        with pytest.raises(RuntimeError, match="nvcc failed"):
            shade_pass(*lanes, sc.shade_rec)
        assert shade_pass.launches == before
    finally:
        _build.library.cache_clear()


@pytest.mark.parametrize("backend", ["compact", "auto"])
@pytest.mark.parametrize("shadows", [False, True])
def test_tiled_on_card_equals_resident(cuda, backend, shadows):
    """The tiled renderer on the card, each tile through the kernels
    (compact: march_pass and shade_pass under the tile's clip window;
    "auto" on these small tiles: render_tile), the shadow sweep through
    march_pass: equal to the resident frame within the tiled bars."""
    terr = T.procedural_terrain(129, seed=7)
    albedo = np.random.default_rng(1).uniform(0.2, 0.9, (129, 129, 3)).astype(np.float32)
    cam = T.Camera.create(eye=(64.5, -38.7, float(terr.max()) + 19.35),
                          target=(64.5, 64.5, float(terr.mean())), device=cuda)
    cfg = T.RenderConfig(width=96, height=64, shading="phong", fog=True, texture=True,
                         shadows=shadows, aux_buffers=True, backend=backend)
    res = T.render_frame(T.make_scene(terr, albedo=albedo, device=cuda), cam,
                         dataclasses.replace(cfg, backend="compact"))
    stats = {}
    m0, f0 = march_pass.launches, render_frame_fused.launches
    tl = T.render_frame_tiled(terr, cam, cfg, tile=64, albedo=albedo, _stats=stats,
                              device=cuda)
    torch.cuda.synchronize()
    shadow_k1 = 2 * stats.get("shadow_tiles_marched", 0)
    if backend == "compact":
        assert march_pass.launches - m0 == 3 * stats["tiles_rendered"] + shadow_k1
    else:
        assert render_frame_fused.launches - f0 == stats["tiles_rendered"]
        assert march_pass.launches - m0 == shadow_k1
    assert torch.equal(tl.hit, res.hit)
    h = res.hit
    torch.testing.assert_close(tl.depth[h], res.depth[h], rtol=1e-4, atol=0)
    assert float((tl.color - res.color).abs().max()) <= 2e-4


def test_frame_counts_on_card_equal_plain(cuda):
    """bench/floor.py on the card (the counting instance) and on the CPU
    (the plain WorkCounter): the same per-ray counts in the launch-order
    pass 0 and the same totals in every launch (the sorted passes may order
    rays of equal keys differently on the two devices)."""
    from hmrt_tpu_torch.bench.floor import count_frame
    terr = T.procedural_terrain(128, seed=3)
    cfg = T.RenderConfig(width=128, height=32, shading="phong", shadows=True)
    got = {}
    for dev in (cuda, "cpu"):
        sc = T.make_scene(terr, device=dev)
        cam = T.Camera.create(eye=(64, -42, float(terr.max()) + 21),
                              target=(64, 64, float(terr.mean())), device=dev)
        got[str(dev)] = count_frame(sc, cam, cfg)
    a, b = got[str(cuda)], got["cpu"]
    assert a.n_primary == b.n_primary and len(a.counts) == len(b.counts) == 5
    assert torch.equal(a.hit.cpu(), b.hit)
    assert torch.equal(a.counts[0].cpu(), b.counts[0])
    assert a.totals(0) == b.totals(0) and a.totals(1) == b.totals(1)


def test_runner_and_timing_on_card(cuda, tmp_path):
    """A small B1 and B2 row on the card: the JAX row's keys, CUDA-event
    times, the device's name; B2 renders through march_pass."""
    from hmrt_tpu_torch.bench.runner import ROW_KEYS, run_bench
    for name, k in (("B1", render_frame_fused), ("B2", march_pass)):
        before = k.launches
        row = run_bench(name, frames=2, scale=0.125, reps=2, floor=name == "B2",
                        out_path=str(tmp_path / f"{name}.json"))
        assert k.launches > before
        assert set(ROW_KEYS) <= set(row) and row["backend"] == "cuda"
        assert row["device"] == torch.cuda.get_device_name(0)
        assert 0 < row["ms_per_frame"] and len(row["all_times_ms"]) == 2
    assert row["lane_steps_per_frame"] == row["lane_steps_primary"] > 0


@pytest.mark.parametrize("backend", ["pallas", "auto"])
def test_debug_counters_on_card(cuda, backend):
    """With debug_counters the fused kernel's frame equals the frame without
    them, and its four planes equal the plain version's per-pixel counts."""
    sc = _scene(65, cuda)
    cam = T.Camera.create(eye=(32.0, -20.0, 40.0), target=(32.0, 32.0, 10.0), device=cuda)
    cfg = T.RenderConfig(width=48, height=24, shading="phong", shadows=True, backend=backend)
    frame, counts = T.render_frame(sc, cam, dataclasses.replace(cfg, debug_counters=True))
    plain = T.render_frame(sc, cam, cfg)
    assert torch.equal(frame.color, plain.color) and torch.equal(frame.hit, plain.hit)
    _, want = render_frame_fused_reference(sc, cam, dataclasses.replace(cfg, debug_counters=True))
    for got, w in zip(counts, want):
        assert got.dtype == torch.int32 and torch.equal(got, w)
