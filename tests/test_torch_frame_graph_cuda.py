"""The compact frame replayed from a CUDA graph, on the card.

Every test here needs a CUDA device and skips without one. On a machine
with a card:
    HMRT_TEST_TPU=1 python -m pytest tests/test_torch_frame_graph_cuda.py -q
"""

import dataclasses
import json

import pytest
import torch

import hmrt_tpu_torch as T
from hmrt_tpu_torch.bench.configs import bench_albedo
from hmrt_tpu_torch.config import RenderConfig
from hmrt_tpu_torch.core.renderer import render_frame
from hmrt_tpu_torch.kernels.compact import GRAPH_STEPS, frame_graphs, render_frame_compact
from hmrt_tpu_torch.kernels.march_pass import march_pass
from hmrt_tpu_torch.kernels.shade_pass import shade_pass
from hmrt_tpu_torch.utils.profiling import tracing

pytestmark = pytest.mark.cuda

N = 1025  # m = 1024: the size from which "auto" takes the compact path

#: each test renders its own sizes, so its first frame has a key of its own
CONFIGS = {
    "phong": dict(shadows=True, shading="phong"),
    "aux": dict(shadows=True, shading="phong", aux_buffers=True),
    "textured_fog": dict(shadows=True, shading="phong", texture=True, fog=True,
                         aux_buffers=True),
}


@pytest.fixture(scope="module")
def world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    dev = torch.device("cuda")
    terr = T.procedural_terrain(N, seed=3)
    return dict(dev=dev, terr=terr, h=float(terr.max()),
                plain=T.make_scene(terr, device=dev),
                textured=T.make_scene(terr, albedo=bench_albedo(terr), device=dev))


def _cameras(w):
    """Grazing, from outside the map, steep, and straight down the up axis
    (`Camera.basis`' fallback)."""
    h, dev = w["h"], w["dev"]
    return [T.Camera.create(eye=eye, target=tgt, device=dev) for eye, tgt in (
        ((80.0, 90.0, h + 4.0), (900.0, 950.0, h * 0.85)),
        ((512.0, -150.0, h + 40.0), (512.0, 512.0, h * 0.4)),
        ((512.0, 260.0, h + 300.0), (520.0, 540.0, 0.0)),
        ((500.0, 530.0, h + 400.0), (500.0, 530.0, 0.0)),
    )]


def _config(name, width, height):
    return RenderConfig(width=width, height=height, backend="compact", **CONFIGS[name])


def _tally():
    return frame_graphs.read()


def _since(before):
    now = frame_graphs.read()
    return {k: now[k] - before[k] for k in GRAPH_STEPS}


def _assert_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert (x is None) == (y is None), f.name
        if x is not None:
            assert x.data_ptr() != y.data_ptr() and torch.equal(x, y), f.name


@pytest.mark.parametrize("name, width", [("phong", 320), ("aux", 328),
                                         ("textured_fog", 336)])
def test_replayed_frames_are_bit_equal_to_eager_frames(world, name, width):
    scene = world["textured" if name == "textured_fog" else "plain"]
    cfg = _config(name, width, 184)
    cams = _cameras(world)
    before = _tally()
    frames = [render_frame(scene, cam, cfg) for cam in cams]
    assert _since(before) == {"eager": 1, "captured": 1, "replayed": len(cams) - 2}
    assert frames[3].color.shape == (184, width, 3)
    assert 0 < int(frames[1].hit.sum()) < 184 * width
    for cam, fr in zip(cams, frames):
        _assert_equal(fr, render_frame_compact(scene, cam, cfg))


def test_a_held_frame_is_unchanged_by_later_replays(world):
    scene, cfg, cams = world["plain"], _config("aux", 344, 192), _cameras(world)
    render_frame(scene, cams[0], cfg)
    held = [render_frame(scene, cams[1], cfg), render_frame(scene, cams[2], cfg)]
    for cam in (cams[3], cams[0], cams[1]):
        render_frame(scene, cam, cfg)
    torch.cuda.synchronize()
    for cam, fr in zip(cams[1:3], held):
        _assert_equal(fr, render_frame_compact(scene, cam, cfg))


def test_replays_wait_on_nothing(world):
    scene, cfg, cams = world["plain"], _config("phong", 352, 192), _cameras(world)
    for cam in cams[:2]:
        render_frame(scene, cam, cfg)
    torch.cuda.synchronize()
    before = _tally()
    torch.cuda.set_sync_debug_mode("error")
    try:
        frames = [render_frame(scene, cam, cfg) for cam in cams]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _since(before) == {"eager": 0, "captured": 0, "replayed": len(cams)}
    for cam, fr in zip(cams, frames):
        _assert_equal(fr, render_frame_compact(scene, cam, cfg))


def test_the_tally_counts_eager_captured_and_replayed_frames(world):
    scene, cfg, cams = world["plain"], _config("phong", 360, 200), _cameras(world)
    before = _tally()
    m0, s0 = march_pass.launches, shade_pass.launches
    for k in range(6):
        render_frame(scene, cams[k % len(cams)], cfg)
    assert _since(before) == {"eager": 1, "captured": 1, "replayed": 4}
    # a replay counts the launches it runs: 5 march passes and 1 shade pass a frame
    assert (march_pass.launches - m0, shade_pass.launches - s0) == (30, 6)
    other = T.make_scene(world["terr"], device=world["dev"])
    before = _tally()
    render_frame(other, cams[0], cfg)  # a new scene
    render_frame(other, cams[0], dataclasses.replace(cfg, shading="lambert"))  # a new config
    render_frame(other, cams[0], dataclasses.replace(cfg, shading="lambert"))
    render_frame(scene, cams[0], cfg)  # the first scene again: its graph is gone
    assert _since(before) == {"eager": 3, "captured": 1, "replayed": 0}


def test_armed_frames_run_eagerly_with_their_spans(world, tmp_path):
    scene, cfg, cams = world["plain"], _config("phong", 368, 200), _cameras(world)
    for cam in cams[:3]:
        render_frame(scene, cam, cfg)
    before = _tally()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof, tracing():
        armed = render_frame(scene, cams[3], cfg)
        torch.cuda.synchronize()
    march_pass.mode_launches.read_live()
    assert _since(before) == {"eager": 1, "captured": 0, "replayed": 0}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"hmrt.frame", "hmrt.raygen", "hmrt.primary", "hmrt.march.pass0", "hmrt.sort",
            "hmrt.shadow", "hmrt.shade"} <= spans
    # the armed frame leaves the graph as it was: the next frame replays it
    replayed = render_frame(scene, cams[3], cfg)
    assert _since(before) == {"eager": 1, "captured": 0, "replayed": 1}
    _assert_equal(armed, replayed)


def test_a_tiled_render_captures_nothing(world):
    cfg = _config("phong", 192, 108)
    cam = _cameras(world)[1]
    stats = {}
    before = _tally()
    T.render_frame_tiled(world["terr"], cam, cfg, tile=256, _stats=stats,
                         device=world["dev"])
    got = _since(before)
    assert stats["tiles_rendered"] > 1 and got["eager"] >= stats["tiles_rendered"]
    assert got["captured"] == got["replayed"] == 0


def test_b4_settings_replay_bit_equal_through_the_textured_shade_kernel(world, tmp_path):
    """B4's render settings (texture, fog, Phong, no shadow rays): the
    eager, captured and replayed frames equal eager renders bit for bit,
    and a replay runs the textured instance of the shade kernel."""
    from port_bench.trace import readable

    scene = world["textured"]
    cfg = RenderConfig(width=320, height=180, backend="compact", shading="phong",
                       shadows=False, texture=True, fog=True, fog_density=0.0015)
    cams = _cameras(world)
    before = _tally()
    frames = [render_frame(scene, cam, cfg) for cam in cams]
    assert _since(before) == {"eager": 1, "captured": 1, "replayed": len(cams) - 2}
    for cam, fr in zip(cams, frames):
        _assert_equal(fr, render_frame_compact(scene, cam, cfg))
    render_frame(scene, cams[2], cfg)
    torch.cuda.synchronize()
    before = _tally()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        replayed = render_frame(scene, cams[3], cfg)
        torch.cuda.synchronize()
    assert _since(before) == {"eager": 0, "captured": 0, "replayed": 1}
    _assert_equal(replayed, frames[3])
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    kernels = [readable(e["name"]) for e in json.loads(path.read_text())["traceEvents"]
               if e.get("cat") == "kernel"]
    assert kernels.count("shade_pass_kernel<true>") == 1
    assert "shade_pass_kernel<false>" not in kernels
