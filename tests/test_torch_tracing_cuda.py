"""The live-lane counts of the march passes and the stage spans, on the card.

Every test here needs a CUDA device and skips without one. On a machine
with a card:
    HMRT_TEST_TPU=1 python -m pytest tests/test_torch_tracing_cuda.py -q
"""

import json

import numpy as np
import pytest
import torch

import hmrt_tpu_torch as T
from conftest import random_rays
from hmrt_tpu_torch.config import RenderConfig
from hmrt_tpu_torch.core.renderer import render_frame
from hmrt_tpu_torch.kernels.compact import empty_results, init_state
from hmrt_tpu_torch.kernels.march_pass import UNBUDGETED, march_pass
from hmrt_tpu_torch.kernels.ray_sort import force_level0
from hmrt_tpu_torch.utils.profiling import tracing

pytestmark = pytest.mark.cuda

N = 257
P = 8192


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    march_pass.mode_launches.read_live()
    yield torch.device("cuda")
    march_pass.mode_launches.read_live()


def _scene(dev):
    return T.make_scene(T.procedural_terrain(N, seed=3), device=dev)


def _rays(dev, seed=0):
    o, d = random_rays(P, N, seed=seed)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
                 for a in (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]))


#: (l0_only, relax, budget) of each instance's pass after pass 0
MODES = {"maxmip": (False, 0, 48), "l0": (True, 0, UNBUDGETED), "relax": (True, 8, UNBUDGETED)}


@pytest.mark.parametrize("counting", [False, True])
@pytest.mark.parametrize("mode", list(MODES))
def test_live_count_equals_torch_and_arming_changes_no_plane(cuda, mode, counting):
    """The tally's count of live lanes is (alive != 0).sum() of the pass's
    input, before each kernel instance (and its counting one), and the
    armed pass's planes and counts are the unarmed pass's, bit for bit."""
    sc = _scene(cuda)
    rays = _rays(cuda)
    kw = dict(n=sc.n, m=sc.m, levels=sc.levels, cell_intersect="triangle",
              pyr_min=sc.pyr_min_flat)
    st = init_state(rays, None, sc.pyr_flat[-1], n=sc.n, m=sc.m, levels=sc.levels)
    st, res = march_pass(rays, st, empty_results(P, cuda), sc.pyr_flat, sc.heights,
                         sc.corners, budget=24, **kw)
    l0_only, relax, budget = MODES[mode]
    if l0_only:
        st = force_level0(rays, st)
    outs, counts = [], []
    for armed in (False, True):
        cnt = torch.empty((2, P), dtype=torch.int32, device=cuda) if counting else None
        march_pass.mode_launches.reset()
        if armed:
            with tracing():
                out = march_pass(rays, st, res, sc.pyr_flat, sc.heights, sc.corners,
                                 budget=budget, counts=cnt, l0_only=l0_only, relax=relax, **kw)
        else:
            out = march_pass(rays, st, res, sc.pyr_flat, sc.heights, sc.corners,
                             budget=budget, counts=cnt, l0_only=l0_only, relax=relax, **kw)
        ran = {k for k, v in march_pass.mode_launches.read().items() if v}
        assert ran == {mode}
        outs.append(out[0] + out[1])
        counts.append(cnt)
    (spans, live, lanes), = march_pass.mode_launches.read_live()
    want = int((st[0] != 0).sum())
    assert 0 < want < P and (live, lanes, spans) == (want, P, ())
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    if counting:
        assert torch.equal(counts[0], counts[1])


def test_unarmed_pass_records_nothing(cuda):
    sc = _scene(cuda)
    rays = _rays(cuda, seed=1)
    st = init_state(rays, None, sc.pyr_flat[-1], n=sc.n, m=sc.m, levels=sc.levels)
    march_pass(rays, st, empty_results(P, cuda), sc.pyr_flat, sc.heights, sc.corners,
               n=sc.n, m=sc.m, levels=sc.levels, budget=UNBUDGETED)
    assert march_pass.mode_launches.read_live() == []


def _frame(sc, cam, cfg):
    fr = render_frame(sc, cam, cfg)
    return fr.color, fr.hit


def test_compact_frame_on_the_card_armed_is_bit_equal_and_every_march_launch_is_in_a_span(
        cuda, tmp_path):
    sc = T.make_scene(T.procedural_terrain(1025, seed=3), device=cuda)
    h = float(sc.pyr_flat[-1])
    cam = T.Camera.create(eye=(512.0, -150.0, h + 40.0), target=(512.0, 512.0, h * 0.4),
                          device=cuda)
    cfg = RenderConfig(width=320, height=180, shadows=True, shading="phong",
                       backend="compact")
    c0, h0 = _frame(sc, cam, cfg)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof, tracing():
        c1, h1 = _frame(sc, cam, cfg)
        torch.cuda.synchronize()
    assert torch.equal(c0, c1) and torch.equal(h0, h1)
    recs = march_pass.mode_launches.read_live()
    assert [r[0][-1] for r in recs] == ["hmrt.march.pass0", "hmrt.march.round",
                                        "hmrt.march.tail", "hmrt.march.round",
                                        "hmrt.march.tail"]
    assert all(0 <= live <= lanes == 320 * 180 for _, live, lanes in recs)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"].startswith("hmrt.march.")]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    k1 = [e for e in events if e.get("cat") == "kernel" and "march_pass_kernel" in e["name"]]
    assert len(k1) == 5 and len(spans) == 5
    for e in k1:
        ts = launch[e["args"]["correlation"]]
        assert any(s <= ts <= t for s, t, _ in spans), e["name"]
