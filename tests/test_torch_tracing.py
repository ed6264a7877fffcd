"""The port's stage spans and live-lane counts (utils/profiling.py), on the
CPU: which spans a frame records, how they nest, that unarmed they cost
one shared no-op and record nothing, that the counts are those of the
alive planes, that the benchmark's `stage_of` charges the shade stage's
inner spans to it, and that arming changes no frame, hit cell or count."""

import json
import os
import tempfile
from collections import Counter

import pytest
import torch

import hmrt_tpu_torch as T
from hmrt_tpu_torch.api.scene import make_scene
from hmrt_tpu_torch.core.renderer import render_frame
from hmrt_tpu_torch.distrib.mesh import render_frame_sharded
from hmrt_tpu_torch.kernels import compact
from hmrt_tpu_torch.kernels.march_pass import march_pass
from hmrt_tpu_torch.utils import profiling
from hmrt_tpu_torch.utils.profiling import maybe_trace, span, tracing
from port_bench.stages import stage_of

N = 65
#: the spans of one B3-like compact frame (shadows, rounds=2, the auto tail),
#: with the live-lane count inside each march launch's span
FRAME_SPANS = {"hmrt.frame": 1, "hmrt.raygen": 1, "hmrt.primary": 1, "hmrt.march.pass0": 1,
               "hmrt.march.round": 2, "hmrt.march.tail": 2, "hmrt.sort": 4,
               "hmrt.unsort": 2, "hmrt.shade": 1, "hmrt.shadow": 1, "hmrt.count": 5}


@pytest.fixture(autouse=True)
def _no_live_records():
    """Each test starts with no live-lane records (an armed render keeps
    them until read)."""
    march_pass.mode_launches.read_live()
    yield
    march_pass.mode_launches.read_live()


@pytest.fixture(scope="module")
def scene():
    return make_scene(T.procedural_terrain(N, seed=3), device="cpu")


@pytest.fixture(scope="module")
def cam(scene):
    return T.Camera.create(eye=(32.0, -20.0, float(scene.pyr_flat[-1]) + 10.0),
                           target=(32.0, 32.0, 5.0), device="cpu")


def _cfg(**kw):
    return T.RenderConfig(**{"width": 40, "height": 24, "shadows": True, "shading": "phong",
                             "backend": "compact", **kw})


def _profiled(fn, armed=True):
    """Run fn under torch.profiler (the port's tracing armed or not);
    returns (fn's result, the exported trace's port spans as (start, end,
    name), main thread only)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        if armed:
            with tracing():
                out = fn()
        else:
            out = fn()
    return out, _spans(prof)


def _spans(prof):
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") == "user_annotation" and e["name"].startswith("hmrt."))


def _parents(spans):
    """Each span with the names of the spans that hold it, outermost first."""
    out, stack = [], []
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] < s:
            stack.pop()
        out.append((name, tuple(x[2] for x in stack)))
        stack.append((s, e, name))
    return out


@pytest.mark.parametrize("frames", [1, 2])
def test_a_compact_frame_records_each_stage_span_nested(scene, cam, frames):
    _, spans = _profiled(lambda: [render_frame(scene, cam, _cfg()) for _ in range(frames)])
    assert Counter(n for _, _, n in spans) == {k: v * frames for k, v in FRAME_SPANS.items()}
    for name, outer in _parents(spans):
        assert outer[:1] == (() if name == "hmrt.frame" else ("hmrt.frame",)), (name, outer)
        if name.startswith("hmrt.march.") or name in ("hmrt.sort", "hmrt.unsort"):
            assert outer[1:] in (("hmrt.primary",), ("hmrt.shade", "hmrt.shadow")), (name, outer)
        if name == "hmrt.shadow":
            assert outer == ("hmrt.frame", "hmrt.shade")
        if name in ("hmrt.raygen", "hmrt.primary", "hmrt.shade"):
            assert outer == ("hmrt.frame",)
        if name == "hmrt.count":
            assert outer[-1].startswith("hmrt.march."), outer
    under = Counter((n, o[1]) for n, o in _parents(spans)
                    if n.startswith(("hmrt.march.", "hmrt.sort", "hmrt.unsort")))
    assert under == {("hmrt.march.pass0", "hmrt.primary"): frames,
                     ("hmrt.march.round", "hmrt.primary"): frames,
                     ("hmrt.march.tail", "hmrt.primary"): frames,
                     ("hmrt.march.round", "hmrt.shade"): frames,
                     ("hmrt.march.tail", "hmrt.shade"): frames,
                     ("hmrt.sort", "hmrt.primary"): 2 * frames,
                     ("hmrt.sort", "hmrt.shade"): 2 * frames,
                     ("hmrt.unsort", "hmrt.primary"): frames,
                     ("hmrt.unsort", "hmrt.shade"): frames}


@pytest.mark.parametrize("fog", [False, True])
@pytest.mark.parametrize("shadows", [False, True])
def test_fog_span_once_a_frame_with_fog_inside_the_shade_stage(scene, cam, fog, shadows):
    _, spans = _profiled(lambda: [render_frame(scene, cam, _cfg(fog=fog, shadows=shadows))
                                  for _ in range(2)])
    names = Counter(n for _, _, n in spans)
    assert names["hmrt.frame"] == names["hmrt.shade"] == 2
    assert names["hmrt.shade.fog"] == (2 if fog else 0)
    assert names["hmrt.shadow"] == (2 if shadows else 0)
    for name, outer in _parents(spans):
        if name == "hmrt.shade.fog":
            assert outer == ("hmrt.frame", "hmrt.shade"), (name, outer)
            assert stage_of(outer + (name,)) == "shade"


def test_the_oracle_path_carries_only_the_frame_span(scene, cam):
    _, spans = _profiled(lambda: render_frame(scene, cam, _cfg(backend="oracle")))
    assert [n for _, _, n in spans] == ["hmrt.frame"]


def test_unarmed_span_is_the_shared_noop_and_records_nothing(scene, cam):
    assert not profiling.armed() and profiling.open_spans() == ()
    assert span("hmrt.a") is span("hmrt.b", "x")
    _, spans = _profiled(lambda: [render_frame(scene, cam, _cfg(fog=fog)) for fog in (False, True)],
                         armed=False)
    assert spans == []
    assert march_pass.mode_launches.read_live() == []


def test_tracing_nests_and_disarms(scene):
    with tracing():
        with tracing():
            assert profiling.armed()
            with span("hmrt.x"):
                with span("hmrt.y"):
                    assert profiling.open_spans() == ("hmrt.x", "hmrt.y")
        assert profiling.armed()
    assert not profiling.armed() and profiling.open_spans() == ()


def test_live_counts_are_the_alive_planes_of_each_launch(scene, cam, monkeypatch):
    want = []
    real = compact.launch_pass

    def counting(rays, state, *a, **kw):
        # the tally sums the alive plane: the port's planes hold 0 or 1
        assert set(state[0].unique().tolist()) <= {0, 1}
        want.append((profiling.open_spans(), int((state[0] != 0).sum()), state[0].shape[0]))
        return real(rays, state, *a, **kw)

    monkeypatch.setattr(compact, "launch_pass", counting)
    with tracing():
        render_frame(scene, cam, _cfg())
    got = march_pass.mode_launches.read_live()
    assert got == want and len(got) == 5
    assert [g[0][-1] for g in got] == ["hmrt.march.pass0", "hmrt.march.round", "hmrt.march.tail",
                                       "hmrt.march.round", "hmrt.march.tail"]
    assert [g[0][1] for g in got] == ["hmrt.primary"] * 3 + ["hmrt.shade"] * 2
    assert all(g[2] == 40 * 24 for g in got) and got[0][1] > got[1][1] > 0
    assert march_pass.mode_launches.read_live() == []  # read once, then forgotten


def test_reset_forgets_the_live_records(scene, cam):
    with tracing():
        render_frame(scene, cam, _cfg())
    march_pass.mode_launches.reset()
    assert march_pass.mode_launches.read_live() == []


@pytest.mark.parametrize("backend", ["compact", "oracle"])
def test_armed_and_unarmed_frames_and_counts_are_bit_equal(scene, cam, backend):
    def frame():
        if backend == "oracle":
            return render_frame(scene, cam, _cfg(backend="oracle", aux_buffers=True)), None
        counts = {"primary": [], "shadow": []}
        fr = compact.render_frame_compact(scene, cam, _cfg(aux_buffers=True), counts=counts)
        return fr, counts

    (f0, c0), (f1, c1) = frame(), _profiled(frame)[0]
    for a, b in ((f0.color, f1.color), (f0.hit, f1.hit), (f0.depth, f1.depth),
                 (f0.normal, f1.normal)):
        assert torch.equal(a, b)
    if c0 is not None:
        for k in c0:
            assert len(c0[k]) == len(c1[k]) > 0
            assert all(torch.equal(a, b) for a, b in zip(c0[k], c1[k]))


def test_maybe_trace_arms_the_spans(scene, cam, tmp_path):
    with maybe_trace(str(tmp_path)):
        assert profiling.armed()
        render_frame(scene, cam, _cfg())
    assert not profiling.armed()
    (path,) = tmp_path.glob("*.json")
    names = Counter(e["name"] for e in json.loads(path.read_text())["traceEvents"]
                    if e.get("cat") == "user_annotation")
    assert names["hmrt.frame"] == 1 and names["hmrt.march.tail"] == 2


def test_make_scene_spans(cam):
    h = T.procedural_terrain(33, seed=1)
    _, spans = _profiled(lambda: make_scene(h, device="cpu"))
    assert dict(_parents(spans)) == {"hmrt.scene": (),
                                     "hmrt.scene.pyramids": ("hmrt.scene",),
                                     "hmrt.scene.records": ("hmrt.scene",)}


def test_tiled_sweep_spans(cam):
    h = T.procedural_terrain(N, seed=3)
    cfg = _cfg()
    fr0 = T.render_frame_tiled(h, cam, cfg, tile=32, device="cpu")
    fr1, spans = _profiled(lambda: T.render_frame_tiled(h, cam, cfg, tile=32, device="cpu"))
    assert torch.equal(fr0.color, fr1.color) and torch.equal(fr0.hit, fr1.hit)
    names = Counter(n for _, _, n in spans)
    assert {"hmrt.tiled.cut", "hmrt.tiled.build", "hmrt.tiled.render",
            "hmrt.tiled.shadow"} <= set(names)
    assert names["hmrt.tiled.render"] == names["hmrt.frame"] >= 1
    for name, outer in _parents(spans):
        if name == "hmrt.frame":
            assert outer == ("hmrt.tiled.render",)
        if name == "hmrt.scene":
            assert outer[-1] == "hmrt.tiled.build"


def test_band_and_gather_spans(scene, cam):
    cfg = _cfg()
    want = render_frame(scene, cam, cfg)
    fr, spans = _profiled(lambda: render_frame_sharded(scene, cam, cfg))
    assert torch.equal(fr.color, want.color) and torch.equal(fr.hit, want.hit)
    names = Counter(n for _, _, n in spans)
    assert names["hmrt.band"] == 1 and names["hmrt.gather"] == 2
    assert names["hmrt.raygen"] == 1 and names["hmrt.frame"] == 0
    assert ("hmrt.raygen", ("hmrt.band",)) in _parents(spans)
