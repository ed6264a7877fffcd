"""The B4-class golden, tests/golden/b4_64.npy: the B4 feature set (Phong,
fog and the height- and slope-coloured albedo texture of
hmrt_tpu/bench/configs.py) on the 64^2 terrain of seed 3, at 64x64 from the
camera of the other goldens (tests/test_renderer.py).

The file was made once from the JAX oracle on the CPU by
`jax_golden_frame` below:

    JAX_PLATFORMS=cpu python -c "import sys; sys.path[:0] = ['.', 'tests'];
        import numpy as np, test_torch_golden as g;
        np.save(g.GOLDEN, g.jax_golden_frame())"

from the root of the checkout. No test writes it; a missing file fails.
The JAX oracle and the port's oracle, compact and fused paths (their
kernels' plain versions on the CPU) must each match it within 1 LSB, the
bar of the JAX goldens."""

import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import hmrt_tpu_torch as T
from hmrt_tpu.api.scene import make_scene as jax_make_scene
from hmrt_tpu.config import RenderConfig as JaxRenderConfig
from hmrt_tpu.core.renderer import render_frame_oracle as jax_render_frame_oracle
from hmrt_tpu.io.heightmap import procedural_terrain as jax_procedural_terrain
from hmrt_tpu.types import Camera as JaxCamera
from hmrt_tpu_torch.bench.configs import bench_albedo

torch.set_num_threads(2)  # the suite runs several workers at once

GOLDEN = Path(__file__).resolve().with_name("golden") / "b4_64.npy"
CONFIG = dict(width=64, height=64, traversal="maxmip", shading="phong", fog=True,
              texture=True)


def jax_albedo(terr):
    """hmrt_tpu/bench/configs.py::bench_scene's albedo, line for line."""
    g = np.gradient(terr)
    slope = np.hypot(g[0], g[1])
    hnorm = (terr - terr.min()) / (np.ptp(terr) + 1e-9)
    grass = np.array([0.3, 0.5, 0.2], np.float32)
    rock = np.array([0.45, 0.4, 0.38], np.float32)
    snow = np.array([0.9, 0.9, 0.95], np.float32)
    w_rock = np.clip(slope / (slope.mean() * 2 + 1e-9), 0, 1)[..., None]
    w_snow = np.clip((hnorm - 0.75) * 4, 0, 1)[..., None]
    albedo = grass * (1 - w_rock) + rock * w_rock
    albedo = albedo * (1 - w_snow) + snow * w_snow
    return albedo.astype(np.float32)


def _camera(terr):
    return dict(eye=(32.0, -20.0, float(terr.max()) + 12.0),
                target=(32.0, 32.0, float(terr.mean())))


def _quantise(color) -> np.ndarray:
    return (np.clip(np.asarray(color), 0, 1) * 255 + 0.5).astype(np.uint8)


def jax_golden_frame() -> np.ndarray:
    """The golden's pixels, uint8 (64, 64, 3), from the JAX oracle."""
    terr = jax_procedural_terrain(64, seed=3)
    scene = jax_make_scene(terr, albedo=jax_albedo(terr), pack=False)
    fr = jax_render_frame_oracle(scene, JaxCamera.create(**_camera(terr)),
                                 JaxRenderConfig(**CONFIG))
    return _quantise(fr.color)


@functools.cache
def _port_scene():
    terr = T.procedural_terrain(64, seed=3)
    return terr, T.make_scene(terr, albedo=bench_albedo(terr), device="cpu")


def _assert_golden(img):
    golden = np.load(GOLDEN)
    assert golden.shape == (64, 64, 3) and golden.dtype == np.uint8
    diff = np.abs(img.astype(int) - golden.astype(int))
    assert (diff <= 1).all(), f"golden mismatch: max diff {diff.max()}, {(diff > 1).sum()} px"


def test_golden_b4_jax_oracle():
    _assert_golden(jax_golden_frame())


def test_golden_b4_pins_texture_and_fog():
    """Without the texture or without fog the frame is off the golden by
    more than the 1-LSB bar."""
    golden = np.load(GOLDEN).astype(int)
    terr, scene = _port_scene()
    cam = T.Camera.create(**_camera(terr), device="cpu")
    for off in ("texture", "fog"):
        cfg = dataclasses.replace(T.RenderConfig(**CONFIG), **{off: False})
        fr = T.render_frame(scene, cam, cfg)
        assert (np.abs(_quantise(fr.color).astype(int) - golden) > 1).mean() > 0.1, off


def test_bench_albedo_equals_jax():
    terr = T.procedural_terrain(64, seed=3)
    np.testing.assert_array_equal(bench_albedo(terr), jax_albedo(terr))


@pytest.mark.parametrize("backend", ["oracle", "compact", "pallas"])
def test_golden_b4_port(backend):
    terr, scene = _port_scene()
    cfg = dataclasses.replace(T.RenderConfig(**CONFIG), backend=backend)
    fr = T.render_frame(scene, T.Camera.create(**_camera(terr), device="cpu"), cfg)
    _assert_golden(_quantise(fr.color))
