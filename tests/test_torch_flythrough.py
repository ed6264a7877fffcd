"""The port's flythrough and animation timing against the JAX package's:
camera paths bit for bit, frames of a textured, fogged Phong orbit through
the port's oracle and compact paths (the kernels' plain versions on the
CPU) against JAX's render_frame, and the timing row's keys."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hmrt_tpu_torch as T
from hmrt_tpu.api.flythrough import flythrough as jax_flythrough
from hmrt_tpu.api.flythrough import frame_camera as jax_frame_camera
from hmrt_tpu.api.flythrough import orbit_flythrough as jax_orbit_flythrough
from hmrt_tpu.api.scene import make_scene as jax_make_scene
from hmrt_tpu.bench.timing import time_animation as jax_time_animation
from hmrt_tpu.config import RenderConfig as JaxRenderConfig
from hmrt_tpu.core.renderer import render_frame as jax_render_frame
from hmrt_tpu.io.heightmap import procedural_terrain
from hmrt_tpu_torch.api.flythrough import frame_camera
from hmrt_tpu_torch.bench.timing import time_animation

torch.set_num_threads(2)  # the suite runs several workers at once

FIELDS = ("eye", "target", "up", "fov_y")
KEYS = [((0, 0, 10), (5, 5, 0)), ((10, 0, 10), (5, 5, 0)), ((10, 10, 12), (5, 5, 0)),
        ((3.3, 7.1, 9.7), (4.0, 6.0, 1.5))]


def _assert_bits(got, want):
    for f in FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, f
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32), err_msg=f)


@pytest.mark.parametrize("n_frames,fov", [(8, 55.0), (13, 60.0), (5, 35.0)])
def test_flythrough_bits_equal_jax(n_frames, fov):
    _assert_bits(T.flythrough(KEYS, n_frames, fov, device="cpu"),
                 jax_flythrough(KEYS, n_frames, fov))


@pytest.mark.parametrize("n,zmax,n_frames", [(8192, 781.5, 8), (65, 7.25, 5), (4096, 301.0, 3)])
def test_orbit_flythrough_bits_equal_jax(n, zmax, n_frames):
    cams = T.orbit_flythrough(n, zmax, n_frames, device="cpu")
    assert cams.eye.shape == (n_frames, 3) and cams.fov_y.shape == (n_frames,)
    _assert_bits(cams, jax_orbit_flythrough(n, zmax, n_frames))


def test_flythrough_needs_two_keyframes():
    with pytest.raises(ValueError):
        T.flythrough(KEYS[:1], 4, device="cpu")


def test_frame_camera_indexes_every_field():
    cams = T.orbit_flythrough(64, zmax=5.0, n_frames=5, device="cpu")
    jcams = jax_orbit_flythrough(64, zmax=5.0, n_frames=5)
    for i in (0, 2, 4):
        c = frame_camera(cams, i)
        assert c.eye.shape == (3,) and c.fov_y.shape == ()
        _assert_bits(c, jax_frame_camera(jcams, i))
    # a single frame renders like a camera made directly
    c2 = frame_camera(cams, 2)
    direct = T.Camera(eye=c2.eye.clone(), target=c2.target.clone(), up=c2.up.clone(),
                      fov_y=c2.fov_y.clone())
    assert all(torch.equal(a, b) for a, b in zip(c2.rays(8, 8), direct.rays(8, 8)))


N = 65
CFG = dict(width=48, height=32, shading="phong", fog=True, texture=True, aux_buffers=True)


@functools.cache
def _world():
    terr = procedural_terrain(N, seed=3)
    albedo = np.random.default_rng(2).uniform(0.2, 0.9, (N, N, 3)).astype(np.float32)
    return terr, albedo


@functools.cache
def _jax_frames():
    terr, albedo = _world()
    cams = jax_orbit_flythrough(N, float(terr.max()), 4)
    sc = jax_make_scene(terr, albedo=albedo)
    out = {}
    for i in (0, 2):
        fr = jax_render_frame(sc, jax_frame_camera(cams, i), JaxRenderConfig(**CFG))
        out[i] = {k: np.asarray(getattr(fr, k)) for k in ("color", "depth", "hit")}
    return out


@pytest.mark.parametrize("backend", ["oracle", "compact"])
@pytest.mark.parametrize("frame", [0, 2])
def test_orbit_frames_match_jax(frame, backend):
    """B4-class frames (texture, fog, Phong) of the orbit: hit mask equal,
    colour within 5e-5 and depth within 1e-4 relative of JAX's."""
    terr, albedo = _world()
    cams = T.orbit_flythrough(N, float(terr.max()), 4, device="cpu")
    sc = T.make_scene(terr, albedo=albedo, device="cpu")
    got = T.render_frame(sc, frame_camera(cams, frame), T.RenderConfig(**CFG, backend=backend))
    want = _jax_frames()[frame]
    hit = want["hit"]
    assert 0.05 < hit.mean() < 0.95
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    assert np.abs(got.color.numpy() - want["color"]).max() <= 5e-5
    np.testing.assert_allclose(got.depth.numpy()[hit], want["depth"][hit], rtol=1e-4)


def test_animated_frames_differ():
    terr, albedo = _world()
    cams = T.orbit_flythrough(N, float(terr.max()), 4, device="cpu")
    sc = T.make_scene(terr, albedo=albedo, device="cpu")
    cfg = T.RenderConfig(width=32, height=16)
    f0 = T.render_frame(sc, frame_camera(cams, 0), cfg)
    f2 = T.render_frame(sc, frame_camera(cams, 2), cfg)
    assert float((f0.color - f2.color).abs().max()) > 0.01


@pytest.mark.parametrize("shadows", [False, True])
def test_time_animation_keys_equal_jax(shadows):
    """The timing row has the JAX row's keys (the JAX side runs a stub scan:
    the keys do not depend on what it renders)."""
    terr, _ = _world()
    cfg = dict(width=16, height=8, shadows=shadows)
    cams = T.orbit_flythrough(N, float(terr.max()), 2, device="cpu")
    got = time_animation(T.make_scene(terr, device="cpu"), cams, T.RenderConfig(**cfg), 2,
                         reps=2, hit_frac=0.5 if shadows else None)
    want = jax_time_animation(None, None, JaxRenderConfig(**cfg), 2, reps=2,
                              render_scan=lambda *a: jnp.float32(0.0),
                              hit_frac=0.5 if shadows else None)
    assert set(got) == set(want)
    assert got["frames"] == 2 and got["reps"] == 2 and len(got["all_times_ms"]) == 2
    assert got["ms_per_frame"] > 0 and got["all_times_ms"] == sorted(got["all_times_ms"])
    if shadows:
        assert got["shadow_rays_per_frame"] == want["shadow_rays_per_frame"] == 64
