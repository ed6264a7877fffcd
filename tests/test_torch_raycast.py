"""The fused render's plain version held against the JAX package's fused
tile kernel (interpret mode on the CPU): the params vector, raygen from it,
whole frames and row bands; the "auto" dispatch rule; the card default of
the entry points."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import hmrt_tpu_torch as T
from hmrt_tpu.api.scene import make_scene as jax_make_scene
from hmrt_tpu.config import RenderConfig as JaxRenderConfig
from hmrt_tpu.io.heightmap import procedural_terrain
from hmrt_tpu.kernels.raycast import (_P_ASPECT, _P_ROW0, make_params as jax_make_params,
                                      render_frame_pallas)
from hmrt_tpu.types import Camera as JaxCamera
from hmrt_tpu_torch.bench.configs import BENCH_CONFIGS, bench_scene
from hmrt_tpu_torch.core.renderer import COMPACT_MIN_M, choose_backend
from hmrt_tpu_torch.kernels.raycast import (fused_planes, fused_reference_planes,
                                            make_params, params_rays, render_frame_fused,
                                            render_frame_fused_reference)

torch.set_num_threads(2)  # the suite runs several workers at once


def _cam(n, terr):
    return dict(eye=(n / 2, -n / 3, float(terr.max()) + n / 6),
                target=(n / 2, n / 2, float(terr.mean())))


@functools.cache
def _scenes(n):
    terr = procedural_terrain(n, seed=3)
    return terr, jax_make_scene(terr), T.make_scene(terr, device="cpu")


CAMERAS = [
    dict(eye=(32.0, -20.0, 40.0), target=(32.0, 32.0, 10.0)),
    dict(eye=(5.0, 7.0, 3.0), target=(60.0, 50.0, 2.0), fov_y_deg=35.0),
    dict(eye=(10.0, 10.0, 5.0), target=(10.0, 10.0, 50.0), fov_y_deg=75.0),
]


@pytest.mark.parametrize("cam", CAMERAS)
@pytest.mark.parametrize("band", [None, (7, 40)])
def test_make_params_matches_jax(cam, band):
    """The params vector with render_frame_pallas' aspect and row0 patches,
    to 1 ulp (torch's tan and XLA's may round an ulp apart)."""
    _, js, ts = _scenes(65)
    row0, fh = band if band else (None, None)
    cfg = dict(width=96, height=16 if band else 24)
    want = jax_make_params(js, JaxCamera.create(**cam))
    want = want.at[0, _P_ASPECT].set(cfg["width"] / (fh or cfg["height"]))
    if row0 is not None:
        want = want.at[0, _P_ROW0].set(row0)
    got = make_params(ts, T.Camera.create(**cam, device="cpu"), T.RenderConfig(**cfg),
                      row0=row0, full_height=fh)
    assert got.shape == (32,) and got.dtype == torch.float32
    np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want).reshape(-1), maxulp=1)


@pytest.mark.parametrize("cam", CAMERAS)
def test_params_rays_equal_camera_rays(cam):
    """Raygen from the params vector equals Camera.rays bit for bit, for the
    whole frame and for 4 row bands stitched together."""
    _, _, ts = _scenes(65)
    c = T.Camera.create(**cam, device="cpu")
    H, W = 24, 40
    cfg = T.RenderConfig(width=W, height=H)
    eye, d = c.rays(H, W)
    rays = params_rays(make_params(ts, c, cfg), H, W, H)
    for k in range(3):
        assert torch.equal(rays[k], eye[k].expand(H * W))
        assert torch.equal(rays[3 + k], d[..., k].reshape(-1))
    band = dataclasses.replace(cfg, height=H // 4)
    parts = [params_rays(make_params(ts, c, band, row0=r, full_height=H), H // 4, W, H)
             for r in range(0, H, H // 4)]
    for k in range(3, 6):
        assert torch.equal(torch.cat([p[k] for p in parts]), rays[k])


@pytest.mark.parametrize("n, cfg", [
    (65, dict(width=128, height=8, shading="lambert")),
    (128, dict(width=128, height=16, shading="phong", shadows=True, aux_buffers=True)),
])
def test_fused_reference_matches_jax_kernel(n, cfg):
    """The plain version against JAX's fused tile kernel in interpret mode:
    hit mask equal, colour < 5e-5, depth and normals within 1e-4."""
    terr, js, ts = _scenes(n)
    cam = _cam(n, terr)
    want = render_frame_pallas(js, js.packed, JaxCamera.create(**cam),
                               JaxRenderConfig(**cfg), interpret=True)
    got = render_frame_fused_reference(ts, T.Camera.create(**cam, device="cpu"),
                                       T.RenderConfig(**cfg))
    hit = np.asarray(want.hit)
    assert 0.0 < hit.mean() < 1.0
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    assert np.abs(got.color.numpy() - np.asarray(want.color)).max() < 5e-5
    if cfg.get("aux_buffers"):
        np.testing.assert_allclose(got.depth.numpy()[hit], np.asarray(want.depth)[hit],
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got.normal.numpy()[hit], np.asarray(want.normal)[hit],
                                   rtol=0, atol=1e-4)


def test_row_bands_stitch_to_the_whole_frame():
    """4 bands of a 32-row screen, stitched, equal the whole plain frame bit
    for bit (colour, depth, normals, hit and hit cells)."""
    terr, _, ts = _scenes(65)
    cam = T.Camera.create(**_cam(65, terr), device="cpu")
    cfg = T.RenderConfig(width=48, height=32, shading="phong", shadows=True,
                         aux_buffers=True)
    whole = fused_reference_planes(ts, cam, cfg)
    band = dataclasses.replace(cfg, height=8)
    parts = [fused_reference_planes(ts, cam, band, row0=r, full_height=32)
             for r in range(0, 32, 8)]
    for k in range(5):
        assert torch.equal(torch.cat([p[k] for p in parts]), whole[k])
    assert whole[3].any() and not whole[3].all()


@pytest.mark.parametrize("device_type, m, backend, want", [
    ("cuda", 256, "auto", "fused"),
    ("cuda", 512, "auto", "fused"),
    ("cuda", COMPACT_MIN_M, "auto", "compact"),
    ("cuda", 4096, "auto", "compact"),
    ("cpu", 256, "auto", "oracle"),
    ("cpu", 4096, "auto", "oracle"),
    ("cuda", 4096, "pallas", "fused"),
    ("cpu", 64, "pallas", "fused"),
    ("cuda", 64, "compact", "compact"),
    ("cuda", 64, "oracle", "oracle"),
])
def test_dispatch_rule(device_type, m, backend, want):
    assert choose_backend(device_type, m, backend) == want


def test_dispatch_rejects_unknown_backend():
    with pytest.raises(ValueError, match="unknown backend"):
        choose_backend("cuda", 64, "tiles")


@pytest.mark.parametrize("fn", [render_frame_fused, render_frame_fused_reference])
def test_debug_counters_raise(fn):
    """debug_counters no longer raises on the fused path: it returns (frame,
    counts), the frame equal to the one rendered without counters and the
    four int32 (H, W) planes equal to the counting instance's
    (`fused_planes(..., counts=)`); the colour also equal to the JAX
    package's fused kernel with its own counters on."""
    terr, js, ts = _scenes(65)
    cam = T.Camera.create(**_cam(65, terr), device="cpu")
    cfg = T.RenderConfig(width=16, height=8, shading="phong", shadows=True,
                         debug_counters=True)
    frame, counts = fn(ts, cam, cfg)
    plain = fn(ts, cam, dataclasses.replace(cfg, debug_counters=False))
    for f in ("color", "hit"):
        assert torch.equal(getattr(frame, f), getattr(plain, f))
    want = torch.empty((4, 8, 16), dtype=torch.int32)
    fused_planes(ts, cam, cfg, counts=want)
    assert isinstance(counts, tuple) and len(counts) == 4
    for got, w in zip(counts, want):
        assert got.dtype == torch.int32 and got.shape == (8, 16)
        assert torch.equal(got, w)
    assert int(counts[0].sum()) > 0 and int(counts[2].sum()) > 0
    jframe, jcounts = render_frame_pallas(js, js.packed, JaxCamera.create(**_cam(65, terr)),
                                          JaxRenderConfig(**dataclasses.asdict(cfg)),
                                          interpret=True)
    assert len(jcounts) == 3
    np.testing.assert_array_equal(frame.hit.numpy(), np.asarray(jframe.hit))
    np.testing.assert_allclose(frame.color.numpy(), np.asarray(jframe.color), atol=5e-5)


def test_entry_points_default_to_the_card():
    """With no device, the entry points put their tensors on the card, and
    raise where there is none: they never fall back to the CPU."""
    terr = procedural_terrain(9, seed=1)
    calls = [lambda: T.make_scene(terr).heights,
             lambda: T.Camera.create(eye=(0, 0, 1), target=(1, 1, 0)).eye,
             lambda: T.Light.create().sun_dir]
    if torch.cuda.is_available():
        for call in calls:
            assert call().device.type == "cuda"
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bench_scene(BENCH_CONFIGS["B1"])
