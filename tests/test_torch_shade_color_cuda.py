"""The colour pass's kernel (kernels/csrc/shade_color.cu) against its plain
torch version, on the card.

Every test here needs a CUDA device and skips without one (a CUDA kernel
has no interpret mode). On a machine with a card:
    HMRT_TEST_TPU=1 python -m pytest tests/test_torch_shade_color_cuda.py -q
"""

import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import hmrt_tpu_torch as T
from hmrt_tpu_torch.bench.configs import BENCH_CONFIGS, bench_albedo, bench_scene
from hmrt_tpu_torch.core.renderer import render_frame
from hmrt_tpu_torch.kernels import compact
from hmrt_tpu_torch.kernels.compact import frame_graphs, render_frame_compact
from hmrt_tpu_torch.kernels.shade_color import shade_color, shade_color_reference
from hmrt_tpu_torch.utils import profiling
from test_torch_shade_color import FLAGS, lanes

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def bench(cuda):
    """B3's and B4's scenes, their bench cameras and a second view each."""
    out = {}
    for name in ("B3", "B4"):
        cfg = BENCH_CONFIGS[name]
        scene, cam, terr = bench_scene(cfg, device=cuda)
        n = cfg.map_n
        view = T.Camera.create(eye=(n * 0.3, n * 0.2, float(terr.max()) + 40.0),
                               target=(n * 0.6, n * 0.7, float(terr.mean())),
                               fov_y_deg=55.0, device=cuda)
        out[name] = (scene, cam, view, cfg.render)
    return out


def _assert_outputs(got, want):
    for k, (a, b) in enumerate(zip(got, want)):
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b), k


def _frame_inputs(scene, cam, rc, monkeypatch):
    """The colour pass's arguments in a compact frame of (scene, cam, rc)."""
    seen = []

    def record(*args):
        seen.append(args)
        return shade_color(*args)
    with monkeypatch.context() as mp:
        mp.setattr(compact, "shade_color", record)
        render_frame_compact(scene, cam, rc)
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("name, lanes_, textured, shadows", [("B3", 2_073_600, False, True),
                                                             ("B4", 921_600, True, False)])
def test_kernel_equals_plain_version_on_a_frames_lanes(bench, monkeypatch, name, lanes_,
                                                        textured, shadows):
    """On the lanes of B3's frame (Phong, shadows) and B4's (textured,
    fog), and again with aux buffers: every output bit for bit."""
    scene, cam, _, rc = bench[name]
    args = _frame_inputs(scene, cam, rc, monkeypatch)
    hit_i, shadow_hit = args[0], args[5]
    assert hit_i.shape == (lanes_,)
    assert rc.texture == textured and (shadow_hit is not None) == shadows
    for cfg in (rc, dataclasses.replace(rc, aux_buffers=True)):
        got = shade_color(*args[:6], scene.light, cfg)
        _assert_outputs(got, shade_color_reference(*args[:6], scene.light, cfg))
    hits = int((hit_i != 0).sum())
    assert 0 < hits < lanes_


@pytest.mark.parametrize("shading, shadows, fog, texture, aux", FLAGS)
def test_kernel_equals_plain_version_over_the_flags(cuda, shading, shadows, fog, texture,
                                                    aux):
    """Every flag of the colour pass on 4,099 lanes (a partial block):
    misses looking up and down, rdv = 0, fog's factor 0; bit for bit."""
    cfg = T.RenderConfig(shading=shading, shadows=shadows, fog=fog, texture=texture,
                         aux_buffers=aux)
    args = lanes(11, p=4099, textured=texture, shadows=shadows)
    args = tuple(None if a is None else tuple(x.to(cuda) for x in a) if isinstance(a, tuple)
                 else a.to(cuda) for a in args)
    light = T.Light.create(device=cuda)
    got = shade_color(*args, light, cfg)
    _assert_outputs(got, shade_color_reference(*args, light, cfg))


@pytest.mark.parametrize("name", ["B3", "B4"])
def test_frames_equal_the_plain_colour_eager_and_replayed(bench, monkeypatch, name):
    """B3's and B4's compact frames through render_frame (eager, captured,
    replayed) equal the frames whose colour is the plain version's, bit
    for bit."""
    scene, cam, view, rc = bench[name]
    render_frame(scene, cam, dataclasses.replace(rc, ambient=0.2))  # a key of its own
    before = frame_graphs.read()
    frames = [render_frame(scene, c, rc) for c in (cam, cam, view, cam)]
    torch.cuda.synchronize()
    now = frame_graphs.read()
    assert {k: now[k] - before[k] for k in now} == {"eager": 1, "captured": 1, "replayed": 2}
    with monkeypatch.context() as mp:
        mp.setattr(compact, "shade_color", shade_color_reference)
        plain = render_frame_compact(scene, cam, rc)
        plain_view = render_frame_compact(scene, view, rc)
    for fr, want in zip(frames, (plain, plain, plain_view, plain)):
        for f in dataclasses.fields(fr):
            a, b = getattr(fr, f.name), getattr(want, f.name)
            assert (a is None) == (b is None), f.name
            if a is not None:
                assert torch.equal(a, b), f.name


class _Ops(TorchDispatchMode):
    """The aten ops a frame runs, with the port's spans open at each."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append((func.overloadpacket.__name__, profiling.open_spans()))
        return func(*args, **(kwargs or {}))


def test_the_shade_stage_runs_no_colour_maths_in_torch(cuda):
    """On the card the shade stage outside the shadow march runs none of
    the colour maths' torch ops (Lambert's and Phong's clamps, the power,
    fog's exp, the sky's root, the stacks), and no op inside the fog span."""
    terr = T.procedural_terrain(1025, seed=3)
    sc = T.make_scene(terr, albedo=bench_albedo(terr), device=cuda)
    cam = T.Camera.create(eye=(512.0, -150.0, 300.0), target=(512.0, 512.0, 40.0), device=cuda)
    rc = T.RenderConfig(width=320, height=180, shading="phong", shadows=True, fog=True,
                        texture=True, backend="compact")
    ops = _Ops()
    with profiling.tracing(), ops:
        render_frame_compact(sc, cam, rc)
    shade = [op for op, spans in ops.seen
             if "hmrt.shade" in spans and "hmrt.shadow" not in spans]
    assert shade
    assert not set(shade) & {"clamp_min", "pow", "exp", "sqrt", "stack", "cat", "neg"}
    assert not [op for op, spans in ops.seen if "hmrt.shade.fog" in spans]


def test_planes_on_two_devices_raise(cuda):
    args = lanes(13, p=512)
    args = args[:5] + (args[5].to(cuda),)
    with pytest.raises(ValueError, match="several devices"):
        shade_color(*args, T.Light.create(device="cpu"), T.RenderConfig(shadows=True))
