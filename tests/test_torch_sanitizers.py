"""The sanitizer layer of the port: the four hostile cameras of
tests/test_sanitizers.py on the 64^2 scene, through the torch oracle and
the compact and fused paths (their kernels' plain versions on the CPU),
each held against the JAX oracle.

JAX runs its oracle under checkify's index and NaN checks. Here torch's
CPU gather and index ops already raise on an index out of range, and every
render runs under `NanCheck`, a dispatch mode that fails on the first op
whose floating-point output holds a NaN. On the card `chip_smoke.py` runs
the same cameras through the CUDA kernels, also under compute-sanitizer's
memcheck.

Under the terrain, 2 of the 256 hits differ from the jitted JAX oracle's,
for causes in the reference (ROADMAP.md §3): XLA's tan(30 degrees) is one
ulp above the correctly rounded value that torch returns, so the two
packages' ray directions differ by 2 ulps; and XLA contracts the jitted
march's multiply-adds, so the JAX oracle jitted and run op by op differ on
a pixel. The test traces every pixel whose hit differs to one of the two,
and holds the port's march on the reference's own ray bits to the
reference run op by op, exactly."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import hmrt_tpu_torch as T
from hmrt_tpu.api.scene import make_scene as jax_make_scene
from hmrt_tpu.config import RenderConfig as JaxRenderConfig
from hmrt_tpu.core.renderer import render_frame_oracle as jax_render_frame_oracle
from hmrt_tpu.io.heightmap import procedural_terrain
from hmrt_tpu.traversal.march import march_maxmip as jax_march_maxmip
from hmrt_tpu.types import Camera as JaxCamera
from hmrt_tpu_torch.traversal.march import march_maxmip

torch.set_num_threads(2)  # the suite runs several workers at once

#: (eye, target) of tests/test_sanitizers.py::HOSTILE_CAMERAS
HOSTILE_CAMERAS = {
    "under the terrain, looking up": ((32.0, 32.0, -50.0), (32.0, 32.0, 100.0)),
    "far outside the box, looking across it": ((-500.0, -500.0, 5.0), (32.0, 32.0, 0.0)),
    "inside the terrain volume, grazing downward": ((31.5, 31.5, 1.0), (200.0, 200.0, -60.0)),
    "outside, looking away from the box": ((-100.0, -100.0, 50.0), (-200.0, -200.0, 80.0)),
}
CONFIG = dict(width=16, height=16, shading="phong", shadows=True, aux_buffers=True)


class NanCheck(TorchDispatchMode):
    """Fails on the first op whose floating-point output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for x in tree_leaves(out):
            if isinstance(x, torch.Tensor) and x.is_floating_point() \
                    and bool(torch.isnan(x).any()):
                raise AssertionError(f"{func} produced a NaN")
        return out


@functools.cache
def _scenes():
    terr = procedural_terrain(64, seed=3)
    return jax_make_scene(terr, pack=False), T.make_scene(terr, device="cpu")


@functools.cache
def _jax_frame(name):
    """The jitted JAX oracle's frame, and the pixels where a hit may differ
    from it for a cause in the reference: the two packages' ray directions
    differ in their bits there, or the reference's march gives another hit
    run op by op than jitted. The port's plain march on the reference's own
    ray bits must give the op-by-op hits exactly."""
    eye, target = HOSTILE_CAMERAS[name]
    js, ts = _scenes()
    jcam = JaxCamera.create(eye=eye, target=target)
    cfg = JaxRenderConfig(**CONFIG)
    fr = jax_render_frame_oracle(js, jcam, cfg)
    want = {k: np.asarray(getattr(fr, k)) for k in ("color", "depth", "normal", "hit")}
    dirs = np.asarray(jcam.rays(16, 16)[1]).reshape(-1, 3)
    p = dirs.shape[0]
    rays = [np.full(p, v, np.float32) for v in eye] + [np.ascontiguousarray(dirs[:, k])
                                                         for k in range(3)]
    kw = dict(n=ts.n, m=ts.m, levels=ts.levels, max_steps=cfg.steps_for(ts.n_cells))
    with jax.disable_jit():
        op_hit = np.asarray(jax_march_maxmip(*rays, js.pyr_flat, js.heights.reshape(-1),
                                             **kw).hit)
    port_hit = march_maxmip(*map(torch.from_numpy, rays), ts.pyr_flat,
                            ts.heights.reshape(-1), **kw).hit.numpy()
    np.testing.assert_array_equal(port_hit, op_hit)
    port_dirs = T.Camera.create(eye=eye, target=target, device="cpu").rays(16, 16)[1]
    ray_bits = (port_dirs.reshape(-1, 3).numpy().view(np.uint32)
                != dirs.view(np.uint32)).any(axis=1)
    explained = (ray_bits | (op_hit != want["hit"].reshape(-1))).reshape(16, 16)
    return want, explained


def test_nan_check_catches_a_nan():
    with pytest.raises(AssertionError, match="produced a NaN"), NanCheck():
        torch.zeros(3) / torch.zeros(3)


@pytest.mark.parametrize("backend", ["oracle", "compact", "pallas"])
@pytest.mark.parametrize("name", list(HOSTILE_CAMERAS))
def test_hostile_camera_matches_jax_oracle(name, backend):
    eye, target = HOSTILE_CAMERAS[name]
    cam = T.Camera.create(eye=eye, target=target, device="cpu")
    cfg = dataclasses.replace(T.RenderConfig(**CONFIG), backend=backend)
    with NanCheck():
        fr = T.render_frame(_scenes()[1], cam, cfg)
    color, normal = fr.color.numpy(), fr.normal.numpy()
    assert np.isfinite(color).all() and (color >= 0).all() and (color <= 1).all()
    assert np.isfinite(normal).all()
    want, explained = _jax_frame(name)
    same = fr.hit.numpy() == want["hit"]
    assert (same | explained).all(), np.argwhere(~same & ~explained)
    assert (~same).sum() <= 2
    hit = want["hit"] & same
    assert np.abs(color - want["color"])[same].max() < 5e-5
    np.testing.assert_allclose(fr.depth.numpy()[hit], want["depth"][hit], rtol=0, atol=1e-4)
