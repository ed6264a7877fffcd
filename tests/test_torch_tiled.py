"""The port's out-of-core tiled renderer: against the port's resident render
(the JAX package's own bars, tests/test_tiled.py) and against the JAX
package's tiled render of the same map and camera (the oracle's bar), with
and without shadows, culled and not, from an array and from a raw file."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import hmrt_tpu_torch as T
from hmrt_tpu.api.tiled import _tile_axis as jax_tile_axis
from hmrt_tpu.api.tiled import render_frame_tiled as jax_render_frame_tiled
from hmrt_tpu.config import RenderConfig as JaxRenderConfig
from hmrt_tpu.io.heightmap import procedural_terrain
from hmrt_tpu.io.native import RawTileMap as JaxRawTileMap
from hmrt_tpu.types import Camera as JaxCamera, Light as JaxLight
from hmrt_tpu_torch.api.tiled import TileSceneCache, _tile_axis
from hmrt_tpu_torch.io.native import RawTileMap

torch.set_num_threads(2)  # the suite runs several workers at once


def test_tile_axis_equals_jax():
    for side, tile in [(129, 64), (120, 64), (65, 64), (40, 64), (8193, 2048), (8192, 2048),
                       (4096, 2048)]:
        assert _tile_axis(side, tile) == jax_tile_axis(side, tile), (side, tile)


def _cam(h):
    n = h.shape[0]
    return dict(eye=(n * 0.5, -n * 0.3, float(h.max()) + n * 0.15),
                target=(n * 0.5, n * 0.5, float(h.mean())))


CLOSE = dict(eye=(20.0, 8.0, None), target=(30.0, 30.0, None), fov_y_deg=50.0)


@functools.cache
def _world(side, seed=7):
    h = procedural_terrain(side, seed=seed)
    albedo = np.random.default_rng(1).uniform(0.2, 0.9, (side, side, 3)).astype(np.float32)
    return h, albedo


CASES = {
    # (side, tile, config, textured, camera, light)
    "129_tex": (129, 64, dict(width=48, height=32, shading="phong", fog=True, texture=True,
                              aux_buffers=True), True, None, None),
    "120_tex": (120, 64, dict(width=48, height=32, shading="phong", fog=True, texture=True,
                              aux_buffers=True), True, None, None),
    "129_shadows": (129, 64, dict(width=48, height=32, shading="phong", shadows=True, fog=True,
                                  texture=True, aux_buffers=True), True, None, None),
    "120_shadows": (120, 64, dict(width=48, height=32, shading="phong", shadows=True,
                                  fog=True, aux_buffers=True), False, None, None),
    "low_sun": (129, 64, dict(width=40, height=28, shadows=True, aux_buffers=True), False,
                None, dict(sun_dir=(0.9, 0.1, 0.25))),
    "close_culled": (129, 32, dict(width=48, height=32, shading="phong", fog=True,
                                   shadows=True, aux_buffers=True), False, "close", None),
}


def _camera(name):
    side = CASES[name][0]
    h, _ = _world(side)
    if CASES[name][4] == "close":
        return dict(CLOSE, eye=(20.0, 8.0, float(h.max()) + 6.0),
                    target=(30.0, 30.0, float(h.mean())))
    return _cam(h)


@functools.cache
def _jax_tiled(name):
    side, tile, cfg, textured, _, light = CASES[name]
    h, albedo = _world(side)
    stats = {}
    fr = jax_render_frame_tiled(h, JaxCamera.create(**_camera(name)), JaxRenderConfig(**cfg),
                                tile=tile, albedo=albedo if textured else None,
                                light=None if light is None else JaxLight.create(**light),
                                _stats=stats)
    return {k: np.asarray(getattr(fr, k)) for k in ("color", "depth", "hit")}, stats


def _port(name, **kw):
    side, tile, cfg, textured, _, light = CASES[name]
    h, albedo = _world(side)
    cfg = T.RenderConfig(**dict(cfg, **kw.pop("cfg", {})))
    lgt = None if light is None else T.Light.create(**light, device="cpu")
    cam = T.Camera.create(**_camera(name), device="cpu")
    return h, albedo if textured else None, lgt, cam, cfg, tile


def _assert_close(got, want, color_tol):
    """Hit equal, depth within 1e-4 relative on hits, colour within tol."""
    hit = want["hit"] if isinstance(want, dict) else want.hit.numpy()
    get = (lambda f, k: f[k]) if isinstance(want, dict) else (lambda f, k: getattr(f, k).numpy())
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_allclose(got.depth.numpy()[hit], get(want, "depth")[hit], rtol=1e-4)
    assert np.abs(got.color.numpy() - get(want, "color")).max() <= color_tol


@pytest.mark.parametrize("name", list(CASES))
def test_tiled_matches_resident_and_jax_tiled(name):
    """Tiled against the port's resident render (colour 2e-4, the JAX
    package's tiled bar) and against JAX's tiled render (colour 5e-5);
    the tile statistics equal JAX's."""
    h, albedo, lgt, cam, cfg, tile = _port(name)
    stats = {}
    tiled = T.render_frame_tiled(h, cam, cfg, tile=tile, albedo=albedo, light=lgt,
                                 _stats=stats, device="cpu")
    resident = T.render_frame(T.make_scene(h, albedo=albedo, light=lgt, device="cpu"), cam, cfg)
    hit = resident.hit.numpy()
    assert 0.0 < hit.mean() < 1.0
    _assert_close(tiled, resident, 2e-4)
    want, jstats = _jax_tiled(name)
    _assert_close(tiled, want, 5e-5)
    assert stats == jstats


@pytest.mark.parametrize("name", ["close_culled", "129_shadows"])
def test_culling_is_pixel_identical(name):
    h, albedo, lgt, cam, cfg, tile = _port(name)
    stats = {}
    culled = T.render_frame_tiled(h, cam, cfg, tile=tile, albedo=albedo, light=lgt,
                                  _stats=stats, device="cpu")
    full = T.render_frame_tiled(h, cam, cfg, tile=tile, albedo=albedo, light=lgt, cull=False,
                                device="cpu")
    for f in ("color", "depth", "normal", "hit"):
        assert torch.equal(getattr(culled, f), getattr(full, f)), f
    if name == "close_culled":
        assert 0 < stats["tiles_rendered"] < stats["tiles_total"] == 16
        assert stats["shadow_tiles_marched"] < stats["tiles_total"]


def test_all_sky_renders_no_tile():
    h, _ = _world(65, seed=3)
    cam = T.Camera.create(eye=(32.0, 32.0, float(h.max()) + 10.0),
                          target=(33.0, 32.0, float(h.max()) + 400.0), device="cpu")
    cfg = T.RenderConfig(width=32, height=24)
    stats = {}
    tiled = T.render_frame_tiled(h, cam, cfg, tile=32, _stats=stats, device="cpu")
    assert stats["tiles_rendered"] == 0 and not bool(tiled.hit.any())
    mono = T.render_frame(T.make_scene(h, device="cpu"), cam, cfg)
    assert torch.equal(tiled.color, mono.color)


def test_compact_path_under_clip_box():
    """The per-tile renders and the shadow sweep through the compact path
    (its kernels' plain versions on the CPU, each march clipped to its
    tile's cell window): equal to the oracle's tiled frame."""
    h, albedo, lgt, cam, cfg, tile = _port("129_shadows")
    oracle = T.render_frame_tiled(h, cam, cfg, tile=tile, albedo=albedo, device="cpu")
    compact = T.render_frame_tiled(h, cam, dataclasses.replace(cfg, backend="compact"),
                                   tile=tile, albedo=albedo, device="cpu")
    _assert_close(compact, oracle, 5e-5)
    np.testing.assert_array_equal(compact.depth.numpy(), oracle.depth.numpy())


def test_raw_tile_map_equals_array_source(tmp_path):
    h = procedural_terrain(100, seed=9)
    path = str(tmp_path / "m.raw")
    h.astype(np.float32).tofile(path)
    cam = T.Camera.create(**_cam(h), device="cpu")
    cfg = T.RenderConfig(width=32, height=24, aux_buffers=True)
    from_array = T.render_frame_tiled(h, cam, cfg, tile=48, device="cpu")
    with RawTileMap(path) as rm, JaxRawTileMap(path) as jm:
        assert rm.side == jm.side == 100
        for args in ((-1, -1, 50, 50), (60, 70, 49, 49), (0, 0, 100, 100)):
            np.testing.assert_array_equal(rm.tile(*args), jm.tile(*args))
        from_file = T.render_frame_tiled(rm, cam, cfg, tile=48, device="cpu")
    for f in ("color", "depth", "hit"):
        assert torch.equal(getattr(from_file, f), getattr(from_array, f)), f
    (tmp_path / "bad.raw").write_bytes(b"\0" * 12)
    with pytest.raises(ValueError, match="not square"):
        RawTileMap(str(tmp_path / "bad.raw"))


def test_scene_cache_reuses_and_is_pixel_neutral():
    h, albedo, lgt, cam, cfg, tile = _port("129_shadows")
    s0, s1, s2 = {}, {}, {}
    plain = T.render_frame_tiled(h, cam, cfg, tile=tile, _stats=s0, device="cpu")
    cache = TileSceneCache(16)
    cached = T.render_frame_tiled(h, cam, cfg, tile=tile, cache=cache, _stats=s1,
                                  device="cpu")
    again = T.render_frame_tiled(h, cam, cfg, tile=tile, cache=cache, _stats=s2,
                                 device="cpu")
    assert torch.equal(cached.color, plain.color) and torch.equal(again.color, plain.color)
    assert s0["tiles_built"] == s0["tiles_rendered"] + s0["shadow_tiles_marched"]
    assert s1["tiles_built"] == s1["tiles_rendered"] and s2["tiles_built"] == 0
    small = TileSceneCache(1)
    T.render_frame_tiled(h, cam, cfg, tile=tile, cache=small, device="cpu")
    assert len(small._d) <= 1
