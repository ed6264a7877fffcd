"""hmrt_tpu_torch basics held against the JAX package: imports, config,
camera rays, terrain, pyramid, gradient planes, scene round trip, PNG."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hmrt_tpu_torch as T
from hmrt_tpu.api.scene import make_scene as jax_make_scene
from hmrt_tpu.config import RenderConfig as JaxRenderConfig
from hmrt_tpu.core.pyramid import build_pyramid_flat as jax_build_pyramid_flat
from hmrt_tpu.io.heightmap import procedural_terrain as jax_procedural_terrain
from hmrt_tpu.io.image import encode_png as jax_encode_png
from hmrt_tpu.kernels.packing import _corner_grads
from hmrt_tpu.types import Camera as JaxCamera, Light as JaxLight
from hmrt_tpu_torch.api.scene import (camera_from_arrays, corner_grads,
                                      scene_from_arrays)
from hmrt_tpu_torch.io.image import encode_png

torch.set_num_threads(2)  # the suite runs several workers at once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_leaves_jax_out():
    """Importing every module of the port pulls in neither jax nor the JAX
    package."""
    code = ("import importlib, pkgutil, sys, hmrt_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, 'hmrt_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'hmrt_tpu' or m.startswith('hmrt_tpu.')]\n"
            "print(len(bad))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0"


def test_render_config_matches_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(JaxRenderConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(T.RenderConfig)]
    assert tf == jf
    for cfg in (dict(traversal="dda"), dict(max_steps=77), dict()):
        assert (T.RenderConfig(**cfg).steps_for(255)
                == JaxRenderConfig(**cfg).steps_for(255))


CAMERAS = [
    dict(eye=(32.0, -20.0, 40.0), target=(32.0, 32.0, 10.0)),
    dict(eye=(5.0, 7.0, 3.0), target=(60.0, 50.0, 2.0), fov_y_deg=35.0),
    # zenith: forward parallel to the up hint (degenerate basis fallback)
    dict(eye=(10.0, 10.0, 5.0), target=(10.0, 10.0, 50.0)),
]


@pytest.mark.parametrize("cam", CAMERAS)
def test_camera_rays_match_jax(cam):
    """Raygen within 1e-6: tan and norm may round an ulp apart."""
    jc, tc = JaxCamera.create(**cam), T.Camera.create(**cam, device="cpu")
    for (h, w, row0, fh) in ((16, 24, None, None), (5, 24, 7, 16)):
        je, jd = jc.rays(h, w, row0=row0, full_height=fh)
        te, td = tc.rays(h, w, row0=row0, full_height=fh)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


def test_raygen_tan_is_the_rounded_f64_tan():
    """Raygen's tan(fov/2) is the f64 tan of the f32 half-angle rounded once
    to f32, for fields of view from 20 to 100 degrees: the bits the card
    gives too (torch's f32 tan on CUDA differs by an ulp at 60 degrees).
    Camera.rays and the fused kernel's params use the same value."""
    import math
    from hmrt_tpu_torch.kernels.raycast import _P_TANHALF, make_params
    from hmrt_tpu_torch.types import tan_half
    scene = T.make_scene(T.procedural_terrain(17, seed=3), device="cpu")
    cfg = T.RenderConfig(width=8, height=4)
    for deg in range(20, 101):
        cam = T.Camera.create(eye=(8, -4, 9), target=(8, 8, 2), fov_y_deg=float(deg),
                              device="cpu")
        half = float((cam.fov_y * 0.5).item())
        want = np.float32(math.tan(np.float64(half))).view(np.int32)
        assert tan_half(cam.fov_y).view(torch.int32).item() == want, deg
        assert make_params(scene, cam, cfg)[_P_TANHALF].view(torch.int32).item() == want, deg


def test_light_matches_jax():
    jl = JaxLight.create(sun_dir=(0.2, -0.5, 0.7))
    tl = T.Light.create(sun_dir=(0.2, -0.5, 0.7), device="cpu")
    for f in dataclasses.fields(jl):
        np.testing.assert_allclose(getattr(tl, f.name).numpy(),
                                   np.asarray(getattr(jl, f.name)), rtol=0, atol=1e-7)


@pytest.mark.parametrize("n", [33, 100])
def test_procedural_terrain_bit_equal(n):
    np.testing.assert_array_equal(T.procedural_terrain(n, seed=5),
                                  jax_procedural_terrain(n, seed=5))


@pytest.mark.parametrize("n", [2, 3, 65, 100, 129])
def test_pyramid_bit_equal(n):
    h = np.random.default_rng(n).uniform(0, 20, (n, n)).astype(np.float32)
    want = np.asarray(jax_build_pyramid_flat(jnp.asarray(h)))
    got = T.build_pyramid_flat(torch.from_numpy(h)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [2, 3, 65, 129])
def test_gradient_planes_bit_equal(n):
    h = np.random.default_rng(n).uniform(0, 20, (n, n)).astype(np.float32)
    jgx, jgy = _corner_grads(jnp.asarray(h))
    tgx, tgy = corner_grads(torch.from_numpy(h))
    np.testing.assert_array_equal(tgx.numpy(), np.asarray(jgx))
    np.testing.assert_array_equal(tgy.numpy(), np.asarray(jgy))


def test_scene_from_arrays_round_trip():
    n = 65
    terr = jax_procedural_terrain(n, seed=3)
    albedo = np.random.default_rng(0).uniform(0.2, 0.9, (n, n, 3)).astype(np.float32)
    js = jax_make_scene(terr, albedo=albedo,
                        light=JaxLight.create(sun_dir=(0.1, 0.8, 0.4)))
    light = {f.name: np.asarray(getattr(js.light, f.name))
             for f in dataclasses.fields(js.light)}
    ts = scene_from_arrays(np.asarray(js.heights), np.asarray(js.pyr_flat),
                           np.asarray(js.albedo), light, n=js.n, m=js.m,
                           levels=js.levels, device="cpu")
    np.testing.assert_array_equal(ts.heights.numpy(), np.asarray(js.heights))
    np.testing.assert_array_equal(ts.pyr_flat.numpy(), np.asarray(js.pyr_flat))
    np.testing.assert_array_equal(ts.albedo.numpy(), np.asarray(js.albedo))
    for k, v in light.items():
        np.testing.assert_array_equal(getattr(ts.light, k).numpy(), v)
    # the port's own make_scene on the same inputs reproduces the state
    own = T.make_scene(terr, albedo=albedo, device="cpu")
    assert (own.n, own.m, own.levels) == (js.n, js.m, js.levels)
    np.testing.assert_array_equal(own.pyr_flat.numpy(), np.asarray(js.pyr_flat))
    np.testing.assert_array_equal(own.albedo.numpy(), np.asarray(js.albedo))
    for a, b in ((own.gx, ts.gx), (own.gy, ts.gy)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())

    cam = JaxCamera.create(eye=(1.0, 2.0, 30.0), target=(40.0, 30.0, 3.0))
    tc = camera_from_arrays(np.asarray(cam.eye), np.asarray(cam.target),
                            np.asarray(cam.up), np.asarray(cam.fov_y), device="cpu")
    assert tc.fov_y.numpy() == np.asarray(cam.fov_y)
    np.testing.assert_allclose(tc.rays(4, 6)[1].numpy(),
                               np.asarray(cam.rays(4, 6)[1]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("bad", [np.zeros((3, 4), np.float32), np.zeros((1, 1), np.float32)])
def test_make_scene_rejects_bad_heights(bad):
    with pytest.raises(ValueError):
        T.make_scene(bad, device="cpu")


def test_encode_png_bytes_equal():
    img = np.random.default_rng(1).uniform(0, 1, (9, 13, 3)).astype(np.float32)
    assert encode_png(img) == jax_encode_png(img)
    assert encode_png(img[..., 0]) == jax_encode_png(img[..., 0])
