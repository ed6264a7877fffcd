"""The compact frame's graph rule, the basis' fallback axis and the
checkless K1 entry, on the CPU (the graphs themselves are on the card:
tests/test_torch_frame_graph_cuda.py)."""

import numpy as np
import pytest
import torch

import hmrt_tpu_torch as T
from conftest import random_rays
from hmrt_tpu_torch.kernels.compact import (GRAPH_STEPS, FrameGraphs, empty_results,
                                            frame_graphs, graph_step, init_state,
                                            render_frame_compact)
from hmrt_tpu_torch.kernels.march_pass import UNBUDGETED, launch_pass, march_pass
from hmrt_tpu_torch.kernels.ray_sort import force_level0
from hmrt_tpu_torch.types import _cross, _norm, y_axis
from hmrt_tpu_torch.utils.profiling import tracing

CPU = torch.device("cpu")
A, B = ("scene a", "config"), ("scene b", "config")


@pytest.mark.parametrize("keys, want", [
    ([A, A, A, A], ["eager", "captured", "replayed", "replayed"]),
    ([A, A, B, B, B, A], ["eager", "captured", "eager", "captured", "replayed", "eager"]),
    ([A, B, A, B], ["eager"] * 4),
    ([None, None, A, None, A, A], ["eager", "eager", "eager", "eager", "captured",
                                   "replayed"]),
])
def test_graph_step_eager_then_capture_then_replay_and_eager_on_a_new_key(keys, want):
    """The rule as FrameGraphs applies it: a key of None leaves the last key
    and its graph as they were (an armed frame between replays)."""
    last, captured, got = None, False, []
    for key in keys:
        step = graph_step(last, key, captured)
        got.append(step)
        if key is not None:
            captured = step != "eager"
            last = key
    assert got == want and set(got) <= set(GRAPH_STEPS)


def _old_basis(cam):
    """Camera.basis as it built its fallback axis before, on every call."""
    f = cam.target - cam.eye
    f = f / _norm(f)
    r = _cross(f, cam.up)
    alt = _cross(f, torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=f.device))
    r = torch.where(torch.sum(r * r) > 1e-12, r, alt)
    r = r / _norm(r)
    return r, _cross(r, f), f


@pytest.mark.parametrize("target", [(3.0, 4.0, -90.0), (3.0, 4.0, 110.0), (40.0, 9.0, 2.0)])
def test_basis_with_the_device_axis_is_bit_equal_to_the_old_expression(target):
    """Straight down and straight up the up axis take the fallback; the
    third camera does not."""
    cam = T.Camera.create(eye=(3.0, 4.0, 10.0), target=target, device=CPU)
    for new, old in zip(cam.basis(), _old_basis(cam)):
        assert torch.equal(new, old)
    assert y_axis(CPU) is y_axis(torch.device("cpu"))
    assert y_axis(CPU).tolist() == [0.0, 1.0, 0.0]


@pytest.fixture(scope="module")
def scene():
    return T.make_scene(T.procedural_terrain(65, seed=3), device=CPU)


def test_render_frame_on_a_cpu_scene_never_captures(scene):
    cam = T.Camera.create(eye=(32.0, -20.0, 40.0), target=(32.0, 32.0, 5.0), device=CPU)
    cfg = T.RenderConfig(width=24, height=16, shadows=True, shading="phong",
                         backend="compact")
    graphs = FrameGraphs()
    before = frame_graphs.read()
    frames = [T.render_frame(scene, cam, cfg) for _ in range(3)]
    with tracing():
        frames.append(graphs.render(scene, cam, cfg))
    frames += [graphs.render(scene, cam, cfg) for _ in range(2)]
    after = frame_graphs.read()
    assert {k: after[k] - before[k] for k in GRAPH_STEPS} == {
        "eager": 3, "captured": 0, "replayed": 0}
    assert graphs.read() == {"eager": 3, "captured": 0, "replayed": 0}
    assert FrameGraphs.key(scene, cam, cfg) is None
    want = render_frame_compact(scene, cam, cfg)
    for fr in frames:
        assert torch.equal(fr.color, want.color) and torch.equal(fr.hit, want.hit)
    graphs.reset()
    assert graphs.read() == dict.fromkeys(GRAPH_STEPS, 0)


@pytest.mark.parametrize("budget, l0_only", [(24, False), (UNBUDGETED, False),
                                             (UNBUDGETED, True)])
def test_launch_pass_is_march_pass_without_its_checks(scene, budget, l0_only):
    o, d = random_rays(512, scene.n, seed=5)
    rays = tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                 for a in (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]))
    st = init_state(rays, None, scene.pyr_flat[-1], n=scene.n, m=scene.m,
                    levels=scene.levels)
    if l0_only:
        st = force_level0(rays, st)
    kw = dict(n=scene.n, m=scene.m, levels=scene.levels, budget=budget, l0_only=l0_only,
              pyr_min=scene.pyr_min_flat)
    args = (rays, st, empty_results(512, CPU), scene.pyr_flat, scene.heights, scene.corners)
    for a, b in zip(march_pass(*args, **kw), launch_pass(*args, **kw)):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
