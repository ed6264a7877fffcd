"""Scene and camera persistence in the JAX package's file format.

Counterpart of `hmrt_tpu/io/state.py`: Camera, Light and RenderConfig go
to `<path>.json`, the heightmap and the (N, N, 3) albedo to `<path>.npz`.
A file written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from hmrt_tpu_torch.config import RenderConfig
from hmrt_tpu_torch.device import resolve
from hmrt_tpu_torch.types import Camera, Light

LIGHT_FIELDS = ("sun_dir", "sun_color", "sky_top", "sky_horizon", "fog_color")


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def save_state(path: str, *, scene=None, camera: Camera | None = None,
               light: Light | None = None, config: RenderConfig | None = None,
               frame_index: int | None = None) -> None:
    """Write <path>.json (+ <path>.npz when a scene is given)."""
    doc = {}
    if camera is not None:
        doc["camera"] = {"eye": _host(camera.eye).tolist(),
                         "target": _host(camera.target).tolist(),
                         "up": _host(camera.up).tolist(),
                         "fov_y": float(_host(camera.fov_y))}
    if light is not None:
        doc["light"] = {k: _host(getattr(light, k)).tolist() for k in LIGHT_FIELDS}
    if config is not None:
        doc["config"] = dataclasses.asdict(config)
    if frame_index is not None:
        doc["frame_index"] = frame_index
    arrays = {}
    if scene is not None:
        arrays["heights"] = _host(scene.heights)
        if scene.albedo is not None:
            n = scene.n
            arrays["albedo"] = _host(scene.albedo).T.reshape(n, n, 3)
        doc["scene_npz"] = os.path.basename(path) + ".npz"
    with open(path + ".json", "w") as f:
        json.dump(doc, f, indent=1)
    if arrays:
        np.savez_compressed(path + ".npz", **arrays)


def load_state(path: str, device=None):
    """Read state written by save_state onto `device` (default: the CUDA
    card); returns a dict with any of 'scene', 'camera', 'light', 'config',
    'frame_index'."""
    device = resolve(device)
    with open(path + ".json") as f:
        doc = json.load(f)
    out = {}
    if "camera" in doc:
        c = doc["camera"]
        cam = Camera.create(eye=c["eye"], target=c["target"], up=c["up"], device=device)
        out["camera"] = dataclasses.replace(
            cam, fov_y=torch.tensor(c["fov_y"], dtype=torch.float32, device=device))
    if "light" in doc:
        out["light"] = Light.create(**{k: doc["light"][k] for k in LIGHT_FIELDS},
                                    device=device)
    if "config" in doc:
        cfg = dict(doc["config"])
        if cfg.get("clip_box") is not None:  # JSON has no tuples
            cfg["clip_box"] = tuple(cfg["clip_box"])
        out["config"] = RenderConfig(**cfg)
    if "frame_index" in doc:
        out["frame_index"] = doc["frame_index"]
    if "scene_npz" in doc:
        from hmrt_tpu_torch.api.scene import make_scene
        npz_path = os.path.join(os.path.dirname(path) or ".", doc["scene_npz"])
        with np.load(npz_path) as z:
            heights = z["heights"]
            albedo = z["albedo"] if "albedo" in z.files else None
        out["scene"] = make_scene(heights, albedo=albedo, light=out.get("light"),
                                  device=device)
    return out
