"""The plain reference renders what the port renders, on small maps on
the CPU (where the port's kernel paths run their plain torch versions),
and its control in bfloat16 is judged not correct by the cells' limits."""

import json

import numpy as np
import pytest
import torch

from port_bench import paths, terrain
from port_bench.reference.render import render as reference
from port_bench.run import compare
from port_bench.tests.conftest import HERE

CASES = [("B3", "flyover", "compact"), ("B3", "topdown", "oracle"), ("B4", "orbit", "compact"),
         ("B4", "lowpass", "compact")]


def _setup(config, traffic, n, size, backend="auto"):
    from hmrt_tpu_torch.api.scene import make_scene
    from hmrt_tpu_torch.config import RenderConfig
    from hmrt_tpu_torch.types import Light

    cfg = json.loads((HERE / "configs" / f"{config}.json").read_text())
    cfg["render"].update(width=size[0], height=size[1], backend=backend)
    tr = json.loads((HERE / "traffic" / f"{traffic}.json").read_text())
    dev = torch.device("cpu")
    cfg["map_n"] = n
    h, alb = terrain.make_inputs(cfg, dev)
    an = None if alb is None else alb.numpy()
    scene = make_scene(h.numpy(), albedo=an, light=Light.create(**cfg["light"], device=dev),
                       device=dev)
    return cfg, tr, h, alb, scene, RenderConfig(**cfg["render"])


@pytest.mark.parametrize("config,traffic,backend", CASES)
def test_reference_equals_the_port(config, traffic, backend):
    from hmrt_tpu_torch.core.renderer import render_frame
    from hmrt_tpu_torch.types import Camera

    cfg, tr, h, alb, scene, rc = _setup(config, traffic, 129, (96, 54), backend)
    for seed in (3, 2**31 + 1):
        eyes, targets, checked = paths.seeded_lap(tr, 129, float(h.max()), seed)
        for pos in checked:
            cam = Camera.create(eye=tuple(eyes[pos]), target=tuple(targets[pos]),
                                fov_y_deg=tr["fov_deg"], device="cpu")
            fr = render_frame(scene, cam, rc)
            col, hit = reference(h, alb, eyes[pos], targets[pos], tr["fov_deg"], cfg["render"],
                                 cfg["light"])
            assert int(hit.sum()) > 0
            assert compare(fr.color, fr.hit, col, hit, 1e-5) == {"hit_px": 0, "color_px": 0}


@pytest.mark.parametrize("config,traffic", [("B3", "flyover"), ("B4", "orbit"), ("B5", "flyover")])
def test_control_fails_the_limits(config, traffic):
    """The reference in bfloat16 in the program's place: some number over
    its limit on every frame, where the port's frames stay under all."""
    from hmrt_tpu_torch.core.renderer import render_frame
    from hmrt_tpu_torch.types import Camera

    cfg, tr, h, alb, scene, rc = _setup(config, traffic, 257, (160, 90), "compact")
    limits = cfg["check"]["limits"]
    for seed in (5, 6, 7):
        eyes, targets, checked = paths.seeded_lap(tr, 257, float(h.max()), seed)
        pos = checked[0]
        args = (eyes[pos], targets[pos], tr["fov_deg"], cfg["render"], cfg["light"])
        ref = reference(h, alb, *args)
        ctl = reference(h, alb, *args, dtype=torch.bfloat16)
        bad = compare(*ctl, *ref, cfg["check"]["color_tol"])
        assert any(bad[k] > lim for k, lim in limits.items()), bad
        fr = render_frame(scene, Camera.create(eye=tuple(eyes[pos]), target=tuple(targets[pos]),
                                               fov_y_deg=tr["fov_deg"], device="cpu"), rc)
        good = compare(fr.color, fr.hit, *ref, cfg["check"]["color_tol"])
        assert all(good[k] <= lim for k, lim in limits.items()), good
    assert np.isfinite(ctl[0].numpy()).all()
