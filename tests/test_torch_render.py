"""Whole frames: the port's oracle and its compact path (the plain kernel
versions on the CPU), each held against the JAX oracle; schedule
invariance; the checked-in goldens; dispatch."""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import hmrt_tpu_torch as T
from hmrt_tpu.api.scene import make_scene as jax_make_scene
from hmrt_tpu.config import RenderConfig as JaxRenderConfig
from hmrt_tpu.core.renderer import render_frame_oracle as jax_render_frame_oracle
from hmrt_tpu.io.heightmap import procedural_terrain
from hmrt_tpu.types import Camera as JaxCamera
from hmrt_tpu_torch.bench.floor import count_frame
from hmrt_tpu_torch.core.renderer import render_frame_oracle
from hmrt_tpu_torch.kernels.compact import render_frame_compact
from hmrt_tpu_torch.kernels.raycast import render_frame_fused_reference

torch.set_num_threads(2)  # the suite runs several workers at once

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
N = 128


@functools.cache
def _terrain():
    return procedural_terrain(N, seed=3)


@functools.cache
def _albedo():
    return np.random.default_rng(0).uniform(0.2, 0.9, (N, N, 3)).astype(np.float32)


def _default_cam(terr):
    n = terr.shape[0]
    return dict(eye=(n / 2, -n / 3, float(terr.max()) + n / 6),
                target=(n / 2, n / 2, float(terr.mean())))


def _case(name):
    """(render config kwargs, camera kwargs, textured) of a named case:
    those of tests/test_compact.py plus an under-terrain and an all-sky
    camera. Every case writes the aux buffers, so depth and normals are
    compared too."""
    terr = _terrain()
    top = float(terr.max())
    cams = {
        "grazing": dict(eye=(-10.0, N / 2, top * 0.9),
                        target=(float(N), N / 2 + 1.0, top * 0.88)),
        "under": dict(eye=(N / 2, N / 2, float(terr.min()) - 2.0),
                      target=(N * 0.9, N * 0.7, float(terr.min()) - 1.0)),
        "sky": dict(eye=(N / 2, -N / 2, top + 20.0),
                    target=(N / 2, -2.0 * N, top + 60.0)),
    }
    cfgs = {
        "phong": dict(width=256, height=64, shading="phong"),
        "shadows": dict(width=128, height=32, shading="phong", shadows=True),
        "aux_fog": dict(width=128, height=32, fog=True),
        "texture": dict(width=128, height=32, texture=True),
        "odd_resolution": dict(width=100, height=37),
        "grazing": dict(width=256, height=16),
        "under": dict(width=64, height=32, shadows=True),
        "sky": dict(width=64, height=32, shading="phong", shadows=True),
    }
    return (dict(cfgs[name], aux_buffers=True), cams.get(name, _default_cam(terr)),
            name == "texture")


CASES = ["phong", "shadows", "aux_fog", "texture", "odd_resolution", "grazing",
         "under", "sky"]


@functools.cache
def _scenes(textured):
    terr = _terrain()
    alb = _albedo() if textured else None
    return jax_make_scene(terr, albedo=alb, pack=False), T.make_scene(terr, albedo=alb, device="cpu")


@functools.cache
def _jax_frame(name):
    cfg, cam, textured = _case(name)
    js, _ = _scenes(textured)
    fr = jax_render_frame_oracle(js, JaxCamera.create(**cam), JaxRenderConfig(**cfg))
    return {k: np.asarray(getattr(fr, k)) for k in ("color", "depth", "normal", "hit")}


def _assert_frame(got, want):
    """Hit mask exact, colour < 5e-5, depth and normal within the JAX
    package's own bars on hits (tests/test_compact.py)."""
    hit = want["hit"]
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    assert np.abs(got.color.numpy() - want["color"]).max() < 5e-5
    np.testing.assert_allclose(got.depth.numpy()[hit], want["depth"][hit],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.normal.numpy()[hit], want["normal"][hit],
                               rtol=0, atol=1e-4)


RENDERERS = {"oracle": render_frame_oracle, "compact": render_frame_compact,
             "fused": render_frame_fused_reference}


@pytest.mark.parametrize("renderer", list(RENDERERS))
@pytest.mark.parametrize("name", CASES)
def test_frame_matches_jax_oracle(name, renderer):
    cfg, cam, textured = _case(name)
    _, ts = _scenes(textured)
    got = RENDERERS[renderer](ts, T.Camera.create(**cam, device="cpu"), T.RenderConfig(**cfg))
    want = _jax_frame(name)
    _assert_frame(got, want)
    frac = want["hit"].mean()
    if name == "sky":
        assert frac == 0.0
    else:
        assert 0.0 < frac < 1.0


@pytest.mark.parametrize("schedule", [(0, 1, 0), (1, 1, 0), (7, 2, 3),
                                      (64, 3, 17), (1000, 2, 1)])
def test_compact_schedule_invariance(schedule):
    """Any (first_budget, rounds, round_budget) renders the same frame,
    bit for bit: the schedule only decides which rays march when."""
    first_budget, rounds, round_budget = schedule
    cfg, cam, _ = _case("shadows")
    _, ts = _scenes(False)
    args = (ts, T.Camera.create(**cam, device="cpu"), T.RenderConfig(**cfg))
    ref = render_frame_compact(*args)
    got = render_frame_compact(*args, first_budget=first_budget, rounds=rounds,
                               round_budget=round_budget)
    for f in ("color", "depth", "normal", "hit"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(ref, f).numpy())


def test_compact_rejects_bad_schedule():
    cfg, cam, _ = _case("shadows")
    _, ts = _scenes(False)
    with pytest.raises(ValueError):
        render_frame_compact(ts, T.Camera.create(**cam, device="cpu"), T.RenderConfig(**cfg),
                             rounds=0)


def _golden_frame(backend, **cfg):
    h = procedural_terrain(64, seed=3)
    cam = T.Camera.create(eye=(32.0, -20.0, float(h.max()) + 12.0),
                          target=(32.0, 32.0, float(h.mean())), device="cpu")
    return T.render_frame(T.make_scene(h, device="cpu"), cam,
                          T.RenderConfig(width=64, height=64, traversal="maxmip",
                                         backend=backend, **cfg))


def _u8(x):
    return (np.clip(x, 0, 1) * 255 + 0.5).astype(np.uint8)


def _assert_golden(img_u8, fname):
    golden = np.load(os.path.join(GOLDEN_DIR, fname))
    diff = np.abs(img_u8.astype(int) - golden.astype(int))
    assert (diff <= 1).all(), f"golden mismatch: max diff {diff.max()}, {(diff > 1).sum()} px"


@pytest.mark.parametrize("backend", ["auto", "compact", "pallas"])
def test_golden_b1(backend):
    fr = _golden_frame(backend, shading="lambert")
    _assert_golden(_u8(fr.color.numpy()), "b1_64.npy")


@pytest.mark.parametrize("backend", ["auto", "compact", "pallas"])
def test_golden_b2(backend):
    fr = _golden_frame(backend, shading="lambert", aux_buffers=True)
    depth = fr.depth.numpy()
    dn = _u8(np.where(np.isfinite(depth), depth, 0.0) / 128.0)
    _assert_golden(np.concatenate([_u8(fr.color.numpy()), dn[:, :, None]], axis=-1),
                   "b2_64.npy")


@pytest.mark.parametrize("backend", ["auto", "compact", "pallas"])
def test_golden_b3(backend):
    fr = _golden_frame(backend, shading="phong", shadows=True)
    _assert_golden(_u8(fr.color.numpy()), "b3_64.npy")


def test_auto_on_cpu_is_the_oracle():
    cfg, cam, _ = _case("shadows")
    _, ts = _scenes(False)
    c = T.Camera.create(**cam, device="cpu")
    a = T.render_frame(ts, c, T.RenderConfig(**cfg))
    b = render_frame_oracle(ts, c, T.RenderConfig(**cfg))
    np.testing.assert_array_equal(a.color.numpy(), b.color.numpy())


def test_pallas_backend_on_cpu_is_the_plain_fused_render():
    """backend="pallas" on a CPU scene runs the fused kernel's plain
    version (the kernel itself runs only on a CUDA scene)."""
    _, ts = _scenes(False)
    cfg, cam, _ = _case("shadows")
    c = T.Camera.create(**cam, device="cpu")
    got = T.render_frame(ts, c, dataclasses.replace(T.RenderConfig(**cfg),
                                                    backend="pallas"))
    want = render_frame_fused_reference(ts, c, T.RenderConfig(**cfg))
    for f in ("color", "depth", "normal", "hit"):
        assert torch.equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("backend", ["pallas", "compact", "auto"])
def test_pallas_backend_raises(backend):
    """backend="pallas" has no case left that raises: with debug_counters
    it returns (frame, counts) with the frame unchanged, and the counter
    planes are the fused march's per-pixel work as its plain version counts
    it; its primary march, which passes under the terrain, takes fewer steps
    than bench/floor.py counts on the compact frame (the same primary
    rays). The compact and oracle ("auto" on the CPU) paths ignore the
    flag, as in the JAX package."""
    _, ts = _scenes(False)
    cfg, cam, _ = _case("shadows")
    c = T.Camera.create(**cam, device="cpu")
    base = dataclasses.replace(T.RenderConfig(**cfg), backend=backend)
    out = T.render_frame(ts, c, dataclasses.replace(base, debug_counters=True))
    want = T.render_frame(ts, c, base)
    if backend != "pallas":
        assert isinstance(out, T.Frame)
        frame = out
    else:
        frame, counts = out
        _, plain = render_frame_fused_reference(ts, c, dataclasses.replace(base,
                                                                           debug_counters=True))
        for a, b in zip(counts, plain):
            assert torch.equal(a, b)
        fc = count_frame(ts, c, base)
        assert 0 < int(counts[0].sum()) < sum(fc.totals(0)[:fc.n_primary])
    for f in ("color", "depth", "normal", "hit"):
        assert torch.equal(getattr(frame, f), getattr(want, f))
