"""State files of the port: a round trip, and files written by either
package read by the other with the same camera, light and config bits,
heights and albedo."""

import dataclasses

import numpy as np
import pytest
import torch

import hmrt_tpu_torch as T
from hmrt_tpu.api.scene import make_scene as jax_make_scene
from hmrt_tpu.config import RenderConfig as JaxRenderConfig
from hmrt_tpu.io.heightmap import procedural_terrain
from hmrt_tpu.io.state import load_state as jax_load_state
from hmrt_tpu.io.state import save_state as jax_save_state
from hmrt_tpu.types import Camera as JaxCamera, Light as JaxLight

LIGHT = ("sun_dir", "sun_color", "sky_top", "sky_horizon", "fog_color")
CAM = ("eye", "target", "up", "fov_y")
CFG = dict(width=320, height=200, shadows=True, fog=True, texture=True, fog_density=0.003)


def _world():
    terr = procedural_terrain(64, seed=7)
    albedo = np.random.default_rng(0).uniform(0, 1, (64, 64, 3)).astype(np.float32)
    return terr, albedo


def _bits(x):
    a = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x, np.float32)
    return a.view(np.int32)


def _assert_same(port, jax_state, terr, albedo):
    """Both packages' reading of one file: equal bits throughout."""
    for f in CAM:
        np.testing.assert_array_equal(_bits(getattr(port["camera"], f)),
                                      _bits(getattr(jax_state["camera"], f)), err_msg=f)
    for f in LIGHT:
        np.testing.assert_array_equal(_bits(getattr(port["light"], f)),
                                      _bits(getattr(jax_state["light"], f)), err_msg=f)
    assert dataclasses.asdict(port["config"]) == dataclasses.asdict(jax_state["config"])
    assert port["frame_index"] == jax_state["frame_index"] == 17
    np.testing.assert_array_equal(port["scene"].heights.numpy(), terr)
    np.testing.assert_array_equal(np.asarray(jax_state["scene"].heights), terr)
    n = terr.shape[0]
    np.testing.assert_array_equal(port["scene"].albedo.numpy().T.reshape(n, n, 3), albedo)
    np.testing.assert_array_equal(np.asarray(jax_state["scene"].albedo).T.reshape(n, n, 3),
                                  albedo)


def test_state_roundtrip(tmp_path):
    terr, albedo = _world()
    light = T.Light.create(sun_dir=(1, 2, 3), device="cpu")
    scene = T.make_scene(terr, albedo=albedo, light=light, device="cpu")
    cam = T.Camera.create(eye=(1, 2, 3), target=(4, 5, 6), fov_y_deg=42.0, device="cpu")
    cfg = T.RenderConfig(width=320, height=200, shadows=True, fog=True)
    base = str(tmp_path / "state")
    T.save_state(base, scene=scene, camera=cam, light=light, config=cfg, frame_index=17)
    st = T.load_state(base, device="cpu")
    assert st["frame_index"] == 17
    assert st["config"] == cfg
    np.testing.assert_allclose(st["camera"].eye.numpy(), [1, 2, 3])
    assert float(st["camera"].fov_y) == np.float32(np.deg2rad(42.0))
    np.testing.assert_array_equal(st["scene"].heights.numpy(), terr)
    np.testing.assert_allclose(st["light"].sun_dir.numpy(), light.sun_dir.numpy(), rtol=1e-6)
    back = st["scene"].albedo.numpy().T.reshape(64, 64, 3)
    np.testing.assert_array_equal(back, albedo)
    # the light rides into the scene
    assert torch.equal(st["scene"].light.sun_dir, st["light"].sun_dir)


def test_state_parts_and_clip_box(tmp_path):
    """Only what was given is written; a clip box comes back as a tuple."""
    base = str(tmp_path / "cfg")
    cfg = T.RenderConfig(clip_box=(1.0, 65.0))
    T.save_state(base, config=cfg)
    st = T.load_state(base, device="cpu")
    assert st == {"config": cfg}
    assert not (tmp_path / "cfg.npz").exists()


def test_jax_written_state_reads_in_port(tmp_path):
    terr, albedo = _world()
    light = JaxLight.create(sun_dir=(0.3, -0.2, 0.9), fog_color=(0.6, 0.7, 0.8))
    scene = jax_make_scene(terr, albedo=albedo, light=light, pack=False)
    cam = JaxCamera.create(eye=(1.5, 2.25, 30.0), target=(40.0, 50.0, 6.0), fov_y_deg=47.0)
    base = str(tmp_path / "jax")
    jax_save_state(base, scene=scene, camera=cam, light=light,
                   config=JaxRenderConfig(**CFG), frame_index=17)
    _assert_same(T.load_state(base, device="cpu"), jax_load_state(base), terr, albedo)


def test_port_written_state_reads_in_jax(tmp_path):
    terr, albedo = _world()
    light = T.Light.create(sun_dir=(0.3, -0.2, 0.9), fog_color=(0.6, 0.7, 0.8), device="cpu")
    scene = T.make_scene(terr, albedo=albedo, light=light, device="cpu")
    cam = T.Camera.create(eye=(1.5, 2.25, 30.0), target=(40.0, 50.0, 6.0), fov_y_deg=47.0,
                          device="cpu")
    base = str(tmp_path / "port")
    T.save_state(base, scene=scene, camera=cam, light=light, config=T.RenderConfig(**CFG),
                 frame_index=17)
    _assert_same(T.load_state(base, device="cpu"), jax_load_state(base), terr, albedo)


def test_load_state_defaults_to_the_card(tmp_path, monkeypatch):
    base = str(tmp_path / "s")
    T.save_state(base, frame_index=3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.load_state(base)
