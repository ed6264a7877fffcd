"""B4's render settings on the port's compact path against the benchmark's
plain reference (`port_bench/reference/render.py`), on the CPU: texture,
distance fog, Phong and no shadow rays on a seeded 129² map at 160×90,
from a key of the published orbit, one of the low pass and a view nearly
straight down. Hit masks are equal and colours within the configuration's
`check.color_tol`; the reference in bfloat16 fails the cell's limits."""

import json

import numpy as np
import pytest
import torch

from hmrt_tpu_torch.api.scene import make_scene
from hmrt_tpu_torch.config import RenderConfig
from hmrt_tpu_torch.core.renderer import render_frame
from hmrt_tpu_torch.types import Camera, Light
from port_bench import paths, terrain
from port_bench.reference.render import render as reference
from port_bench.run import compare
from port_bench.tests.conftest import HERE

N = 129
SIZE = (160, 90)
VIEWS = ("orbit", "lowpass", "vertical")


@pytest.fixture(scope="module")
def b4():
    cfg = json.loads((HERE / "configs" / "B4.json").read_text())
    cfg["map_n"] = N
    cfg["render"].update(width=SIZE[0], height=SIZE[1], backend="compact")
    dev = torch.device("cpu")
    h, alb = terrain.make_inputs(cfg, dev)
    scene = make_scene(h.numpy(), albedo=alb.numpy(),
                       light=Light.create(**cfg["light"], device=dev), device=dev)
    return dict(cfg=cfg, h=h, alb=alb, scene=scene, rc=RenderConfig(**cfg["render"]))


def _view(name: str, zmax: float):
    """(eye, target, fov): the first key of a traffic's lap, or a camera
    above the map's centre looking nearly straight down."""
    if name == "vertical":
        c = (N - 1) / 2.0
        return (c + 0.7, c - 2.0, zmax + 60.0), (c, c, 0.0), 55.0
    tr = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    eyes, targets = paths.lap_views(tr, N, zmax)
    return tuple(eyes[0]), tuple(targets[0]), float(tr["fov_deg"])


def _reference(b4, view, dtype=torch.float32):
    eye, target, fov = _view(view, float(b4["h"].max()))
    cfg = b4["cfg"]
    return reference(b4["h"], b4["alb"], eye, target, fov, cfg["render"], cfg["light"],
                     dtype=dtype)


@pytest.mark.parametrize("view", VIEWS)
def test_port_renders_b4_as_the_reference(b4, view):
    eye, target, fov = _view(view, float(b4["h"].max()))
    fr = render_frame(b4["scene"], Camera.create(eye=eye, target=target, fov_y_deg=fov,
                                                 device="cpu"), b4["rc"])
    color, hit = _reference(b4, view)
    assert 0 < int(hit.sum()) < SIZE[0] * SIZE[1]
    assert torch.equal(fr.hit, hit)
    tol = b4["cfg"]["check"]["color_tol"]
    assert float((fr.color - color).abs().amax()) <= tol
    assert compare(fr.color, fr.hit, color, hit, tol) == {"hit_px": 0, "color_px": 0}


@pytest.mark.parametrize("view", VIEWS)
def test_bfloat16_reference_fails_b4_limits(b4, view):
    check = b4["cfg"]["check"]
    ctl = _reference(b4, view, torch.bfloat16)
    assert np.isfinite(ctl[0].numpy()).all()
    bad = compare(*ctl, *_reference(b4, view), check["color_tol"])
    assert any(bad[k] > lim for k, lim in check["limits"].items()), bad
