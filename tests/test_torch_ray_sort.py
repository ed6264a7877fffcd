"""The sorted rounds' reorder on the CPU (kernels/ray_sort.py): the plain
version, a stable argsort by column key and one gather a plane, against the
chain it replaced and against its definition. The CUDA kernel is held to
this plain version in tests/test_torch_ray_sort_cuda.py."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import hmrt_tpu_torch as T
from hmrt_tpu_torch.kernels import compact
from hmrt_tpu_torch.kernels.compact import (FIRST_BUDGET, ROUND_BUDGET, ROUNDS, init_state,
                                            march_rounds, primary_rays, render_frame_compact)
from hmrt_tpu_torch.kernels.ray_sort import (L0_TAIL_AUTO_THRESH, column_key, force_level0,
                                             l0_tail_flag, ray_sort, ray_unsort)

torch.set_num_threads(2)  # the suite runs several workers at once

N = 128


def sort_planes(p: int, m: int, seed: int = 0, kind: str = "mixed", device="cpu"):
    """(rays, state, res) of p lanes over an m-cell map, as a sorted round
    finds them. kind: "mixed" (half the lanes alive, any level), "l0"
    (19 of 20 live lanes at level 0, so "auto" forces the tail), "dead"
    (no lane alive), "one_column" (every lane alive in one 32-cell column)."""
    g = torch.Generator().manual_seed(seed)
    levels = m.bit_length()

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(p, generator=g)

    alive = (torch.rand(p, generator=g) < 0.5).to(torch.int32)
    lvl = torch.randint(0, levels, (p,), generator=g, dtype=torch.int32)
    if kind == "l0":
        alive = torch.ones(p, dtype=torch.int32)
        lvl = torch.where(torch.rand(p, generator=g) < 0.95, 0, lvl).to(torch.int32)
    elif kind == "dead":
        alive = torch.zeros(p, dtype=torch.int32)
    elif kind == "one_column":
        alive = torch.ones(p, dtype=torch.int32)
        lvl = torch.randint(0, min(levels, 6), (p,), generator=g, dtype=torch.int32)
    side = (m >> lvl).clamp(min=1).to(torch.float32)
    if kind == "one_column":  # the cells under column (3, 1) of 32 level-0 cells
        side = torch.full((p,), 32.0) / (1 << lvl).to(torch.float32)
    icx = (torch.rand(p, generator=g) * side).to(torch.int32)
    icy = (torch.rand(p, generator=g) * side).to(torch.int32)
    if kind == "one_column":
        icx = icx + (3 * 32 >> lvl)
        icy = icy + (32 >> lvl)
    t = uniform(0.0, 2.0 * m)
    rays = (uniform(-0.5 * m, 1.5 * m), uniform(-0.5 * m, 1.5 * m), uniform(0.0, 0.3 * m),
            uniform(-1.0, 1.0), uniform(-1.0, 1.0), uniform(-0.5, 0.2))
    state = (alive, t, lvl, icx, icy)
    res = ((torch.rand(p, generator=g) < 0.3).to(torch.int32), uniform(0.0, m),
           torch.randint(0, m, (p,), generator=g, dtype=torch.int32),
           torch.randint(0, m, (p,), generator=g, dtype=torch.int32))
    return tuple(tuple(x.to(device) for x in planes) for planes in (rays, state, res))


def _old_ray_sort(rays, state, res, perm_tot, *, m5, moving, tail=False):
    """The chain the sorted rounds ran before kernels/ray_sort.py: dead lanes
    keyed 2**30, torch's default argsort, every result plane gathered."""
    if res is None:
        res = compact.empty_results(state[0].shape[0], state[0].device)
    flag = tail
    if tail:
        forced = force_level0(rays, state)
        if tail == "auto":
            flag = l0_tail_flag(state)
            forced = tuple(torch.where(flag, f, s) for f, s in zip(forced, state))
        state = forced
    alive, _, lvl, icx, icy = state
    key = torch.where(alive != 0, torch.clamp((icy << lvl) >> 5, 0, m5 - 1) * m5
                      + torch.clamp((icx << lvl) >> 5, 0, m5 - 1), 2 ** 30)
    perm = torch.argsort(key)
    rays = tuple(x.index_select(0, perm) if i in moving else x for i, x in enumerate(rays))
    state = tuple(x.index_select(0, perm) for x in state)
    res = tuple(x.index_select(0, perm) for x in res)
    perm_tot = perm if perm_tot is None else perm_tot.index_select(0, perm)
    return rays, state, res, perm_tot, flag


@functools.cache
def _scene(textured: bool):
    terr = T.procedural_terrain(N, seed=3)
    alb = (np.random.default_rng(0).uniform(0.2, 0.9, (N, N, 3)).astype(np.float32)
           if textured else None)
    return T.make_scene(terr, albedo=alb, device="cpu"), terr


#: (config, camera) of tests/test_compact.py's scenes, as
#: tests/test_torch_render.py renders them, on its 128² map
CASES = {
    "phong": (dict(width=256, height=64, shading="phong"), None),
    "shadows": (dict(width=128, height=32, shading="phong", shadows=True), None),
    "aux_fog": (dict(width=128, height=32, fog=True), None),
    "texture": (dict(width=128, height=32, texture=True), None),
    "odd_resolution": (dict(width=100, height=37), None),
    "grazing": (dict(width=256, height=16, shadows=True), "grazing"),
    "under": (dict(width=64, height=32, shadows=True), "under"),
}


def _camera(name, terr):
    top, low = float(terr.max()), float(terr.min())
    eye, tgt = {
        None: ((N / 2, -N / 3, top + N / 6), (N / 2, N / 2, float(terr.mean()))),
        "grazing": ((-10.0, N / 2, top * 0.9), (float(N), N / 2 + 1.0, top * 0.88)),
        "under": ((N / 2, N / 2, low - 2.0), (N * 0.9, N * 0.7, low - 1.0)),
    }[name]
    return T.Camera.create(eye=eye, target=tgt, device="cpu")


@pytest.mark.parametrize("name", list(CASES))
def test_plain_reorder_gives_the_frames_of_the_old_chain(name, monkeypatch):
    """The stable-argsort chain renders every frame of the chain it replaced,
    bit for bit, with the tail off, forced and "auto" and a third round."""
    cfg, cam_name = CASES[name]
    scene, terr = _scene(cfg.get("texture", False))
    cfg = T.RenderConfig(**cfg, aux_buffers=True)
    cam = _camera(cam_name, terr)
    for kw in (dict(l0_tail=False), dict(l0_tail=True), dict(rounds=3, round_budget=5)):
        new = render_frame_compact(scene, cam, cfg, **kw)
        with monkeypatch.context() as mp:
            mp.setattr(compact, "ray_sort", _old_ray_sort)
            old = render_frame_compact(scene, cam, cfg, **kw)
        for f in dataclasses.fields(new):
            assert torch.equal(getattr(new, f.name), getattr(old, f.name)), (kw, f.name)
    assert 0 < int(new.hit.sum()) < new.hit.numel()


@pytest.mark.parametrize("m, kind", [(4096, "mixed"), (8192, "mixed"), (256, "mixed"),
                                     (64, "one_column"), (4096, "dead")])
def test_plain_reorder_is_a_stable_sort_by_column_key(m, kind):
    """The permutation is argsort(column_key, stable=True); every moving
    plane, state plane and result plane is its index_select, the others
    are left as they are; the running permutation composes."""
    rays, state, res = sort_planes(3001, m, seed=m, kind=kind)
    m5 = max(m // 32, 1)
    perm_in = torch.randperm(3001, generator=torch.Generator().manual_seed(1))
    r2, s2, res2, perm_tot, flag = ray_sort(rays, state, res, perm_in, m5=m5,
                                            moving=(3, 4, 5))
    key = column_key(state, m5)
    perm = torch.argsort(key, stable=True)
    assert flag is False
    assert torch.equal(perm_tot, perm_in[perm])
    for i, (x, y) in enumerate(zip(rays, r2)):
        assert (y is x) if i < 3 else torch.equal(y, x[perm])
    for x, y in zip(state + res, s2 + res2):
        assert torch.equal(y, x[perm])
    assert torch.equal(key[perm], torch.sort(key).values)
    _, _, none, _, _ = ray_sort(rays, state, None, None, m5=m5, moving=(0, 1, 2))
    assert none is None


def test_dead_lanes_go_last_in_lane_order():
    """Dead lanes key m5**2, the bucket after every live column: they follow
    every live lane, in lane order, and live lanes of one column keep
    their lane order."""
    rays, state, res = sort_planes(5000, 4096, seed=7)
    _, s2, _, perm, _ = ray_sort(rays, state, res, None, m5=128, moving=(3, 4, 5))
    alive = state[0] != 0
    n = int(alive.sum())
    assert 0 < n < 5000
    assert torch.equal(perm[n:], torch.nonzero(~alive).flatten())
    assert bool((s2[0][:n] != 0).all()) and not bool(s2[0][n:].any())
    key = column_key(state, 128)[perm[:n]]
    assert int(key.max()) < 128 * 128
    same = key[1:] == key[:-1]
    assert bool((perm[1:n][same] > perm[:n - 1][same]).all())


@pytest.mark.parametrize("tail, kind, forced", [(True, "mixed", True), ("auto", "l0", True),
                                                ("auto", "mixed", False)])
def test_tail_round_keys_and_planes_are_force_level0_then_column_key(tail, kind, forced):
    """A tail round reorders the lanes as force_level0 and then column_key
    order them, and carries the forced planes; "auto" does so only where
    the flag says so (19 of 20 live lanes at level 0: forced; any level:
    not), and returns the flag for the tail pass."""
    rays, state, res = sort_planes(4099, 4096, seed=11, kind=kind)
    flag_want = l0_tail_flag(state)
    if tail == "auto":
        assert bool(flag_want) == forced
    want_state = force_level0(rays, state) if forced else state
    perm = torch.argsort(column_key(want_state, 128), stable=True)
    _, s2, res2, perm_tot, flag = ray_sort(rays, state, res, None, m5=128, moving=(3, 4, 5),
                                           tail=tail)
    assert torch.equal(perm_tot, perm)
    for x, y in zip(want_state + res, s2 + res2):
        assert torch.equal(y, x[perm])
    if tail is True:
        assert flag is True
    else:
        assert flag.dtype == torch.bool and bool(flag) == forced
    assert bool((s2[2] == 0).all()) == forced
    n_alive = int((state[0] != 0).sum())
    assert (int(((state[0] != 0) & (state[2] == 0)).sum())
            > int(L0_TAIL_AUTO_THRESH * n_alive)) == bool(flag_want)


def test_unsort_returns_planes_to_launch_order():
    """ray_unsort inverts the running permutation of two rounds."""
    rays, state, res = sort_planes(2500, 1024, seed=5)
    r1, s1, res1, perm, _ = ray_sort(rays, state, res, None, m5=32, moving=(3, 4, 5))
    s1 = (s1[0], s1[1], torch.flip(s1[2], (0,)), s1[3], s1[4])  # another order of keys
    _, _, res2, perm, _ = ray_sort(r1, s1, res1, perm, m5=32, moving=(3, 4, 5))
    back = ray_unsort(res2, perm)
    for x, y in zip(res, back):
        assert torch.equal(x, y)


def test_march_rounds_returns_the_result_planes_it_keeps():
    """keep=(0,), the shadow march's, returns the hit plane of the full
    result in launch order, and leaves the launch counter alone on the CPU."""
    scene, terr = _scene(False)
    cfg = T.RenderConfig(width=96, height=40)
    rays = primary_rays(_camera(None, terr), cfg)
    st = init_state(rays, None, scene.pyr_flat[-1], n=scene.n, m=scene.m, levels=scene.levels)
    kw = dict(cell_intersect=cfg.cell_intersect, clip=None, first_budget=FIRST_BUDGET,
              rounds=ROUNDS, round_budget=ROUND_BUDGET, moving=(3, 4, 5))
    before = ray_sort.launches
    full = march_rounds(rays, st, scene, **kw)
    (hit,) = march_rounds(rays, st, scene, keep=(0,), **kw)
    assert len(full) == 4 and torch.equal(hit, full[0]) and int(hit.sum()) > 0
    assert ray_sort.launches == before
