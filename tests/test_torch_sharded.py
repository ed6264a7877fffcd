"""The port's multi-rank renders (hmrt_tpu_torch/distrib) on the CPU: 2 and
4 gloo ranks, spawned as processes, against the JAX package's sharded
render on its 8 virtual CPU devices and against single-device renders.

Bars (ROADMAP.md): hit masks exact, colour 5e-5, depth 1e-4; a band of the
port's own paths equals the same rows of its full frame bit for bit.
"""

import dataclasses
from datetime import timedelta

import jax
import numpy as np
import pytest
import torch

import hmrt_tpu as H
import hmrt_tpu_torch as T
from hmrt_tpu.api.flythrough import frame_camera as jax_frame_camera
from hmrt_tpu.api.flythrough import orbit_flythrough as jax_orbit_flythrough
from hmrt_tpu.distrib.mesh import make_mesh as jax_make_mesh
from hmrt_tpu.distrib.mesh import render_frame_sharded as jax_render_frame_sharded
from hmrt_tpu.distrib.mesh import replicate_scene as jax_replicate_scene
from hmrt_tpu_torch.api.flythrough import frame_camera
from hmrt_tpu_torch.distrib.dryrun import dryrun_multichip, render_sharded_jobs, scene_digest
from hmrt_tpu_torch.distrib.mesh import (Mesh, render_flythrough_sharded,
                                         render_frame_sharded, spawn)

torch.set_num_threads(2)  # the suite runs several workers at once

N = 64
BASE = H.RenderConfig(width=64, height=32, shading="phong", shadows=True, aux_buffers=True)
FLY = H.RenderConfig(width=32, height=24, shading="phong", shadows=True, fog=True)
PATHS = {"oracle": "auto", "compact": "compact", "fused": "pallas"}
FLY_FRAMES = 4


def _port_config(cfg, **kw):
    """The port's RenderConfig of a JAX one: a spawned rank unpickles only
    what the port defines, so it never imports JAX."""
    return T.RenderConfig(**dataclasses.asdict(dataclasses.replace(cfg, **kw)))


def _terrain():
    return H.procedural_terrain(N, seed=3)


def _camera(terr):
    return ((32.0, -20.0, float(terr.max()) + 12.0), (32.0, 32.0, float(terr.mean())), 60.0)


@pytest.fixture(scope="module")
def runs():
    """One spawn per rank count: the 64x32 frame by each path and the
    4-frame orbit, rendered sharded by every rank (rank 0's results)."""
    terr = _terrain()
    jobs = [dict(source=terr, config=_port_config(BASE, backend=b), camera=_camera(terr))
            for b in PATHS.values()]
    jobs.append(dict(source=terr, config=_port_config(FLY),
                     orbit=(FLY_FRAMES, FLY_FRAMES, float(terr.max()))))
    return {k: spawn(render_sharded_jobs, k, args=(jobs,), backend="gloo", devices=["cpu"] * k,
                     timeout=timedelta(seconds=60), join_timeout=60, threads=1)
            for k in (2, 4)}


@pytest.fixture(scope="module")
def port_scene():
    return T.make_scene(_terrain(), device="cpu")


@pytest.fixture(scope="module")
def jax_frame():
    terr = _terrain()
    eye, target, _ = _camera(terr)
    mesh = jax_make_mesh()
    assert mesh.devices.size == 8
    return jax_render_frame_sharded(jax_replicate_scene(H.make_scene(terr), mesh),
                                    H.Camera.create(eye=eye, target=target), BASE, mesh)


def _port_camera(terr):
    eye, target, fov = _camera(terr)
    return T.Camera.create(eye=eye, target=target, fov_y_deg=fov, device="cpu")


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("ranks", [2, 4])
def test_sharded_frame_equals_jax_sharded_frame(runs, jax_frame, ranks, path):
    got = runs[ranks][list(PATHS).index(path)]
    np.testing.assert_array_equal(got["hit"], np.asarray(jax_frame.hit))
    np.testing.assert_allclose(got["color"], np.asarray(jax_frame.color), atol=5e-5, rtol=0)
    hit = np.asarray(jax_frame.hit)
    np.testing.assert_allclose(got["depth"][hit], np.asarray(jax_frame.depth)[hit], atol=1e-4,
                               rtol=1e-5)
    assert np.isinf(got["depth"][~hit]).all()


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("ranks", [2, 4])
def test_bands_equal_the_full_frame_bit_for_bit(runs, port_scene, ranks, path):
    """Each rank's band through the same path (compact and fused with the
    kernels' plain versions on the CPU) gives the rows of the port's full frame."""
    got = runs[ranks][list(PATHS).index(path)]
    cfg = _port_config(BASE, backend=PATHS[path])
    want = T.render_frame(port_scene, _port_camera(_terrain()), cfg)
    for k in ("color", "hit", "depth", "normal"):
        np.testing.assert_array_equal(got[k], getattr(want, k).numpy(), err_msg=k)
    assert got["frame"] == {"hit_diff": 0, "color_max_err": 0.0, "depth_diff": 0,
                            "normal_max_err": 0.0}


def test_compact_band_equals_rows_of_the_full_compact_frame(port_scene):
    """The compact band form in-process: rows [row0, row0 + band) of any
    band, an edge band with no terrain in view included, are the full
    frame's rows."""
    from hmrt_tpu_torch.kernels.compact import render_frame_compact
    cfg = _port_config(BASE, backend="compact")
    cam = _port_camera(_terrain())
    full = render_frame_compact(port_scene, cam, cfg)
    assert not bool(full.hit[:4].any())   # the top band sees sky only
    for row0, band in ((0, 4), (12, 8), (29, 3)):
        fr = render_frame_compact(port_scene, cam, dataclasses.replace(cfg, height=band),
                                  row0=row0, full_height=cfg.height)
        for k in ("color", "hit", "depth", "normal"):
            assert torch.equal(getattr(fr, k), getattr(full, k)[row0:row0 + band]), (row0, k)
    with pytest.raises(ValueError, match="outside"):
        render_frame_compact(port_scene, cam, dataclasses.replace(cfg, height=8), row0=30,
                             full_height=32)


@pytest.mark.parametrize("ranks", [2, 4])
def test_flythrough_sharded_equals_jax_frames(runs, ranks):
    terr = _terrain()
    got = runs[ranks][-1]
    assert got["stack"].shape == (FLY_FRAMES, 24, 32, 3)
    assert got["stack_max_err"] == [0.0] * FLY_FRAMES   # equal to render_frame on the rank
    scene = H.make_scene(terr)
    cams = jax_orbit_flythrough(N, float(terr.max()), FLY_FRAMES)
    for i in range(FLY_FRAMES):
        want = H.render_frame(scene, jax_frame_camera(cams, i), FLY)
        np.testing.assert_allclose(got["stack"][i], np.asarray(want.color), atol=5e-5, rtol=0,
                                   err_msg=f"frame {i}")


@pytest.mark.parametrize("ranks", [2, 4])
def test_replicate_scene_gives_every_rank_rank0s_bits(runs, port_scene, ranks):
    want = scene_digest(port_scene).numpy()
    for job in runs[ranks]:
        digests = job["scene_digests"]
        assert digests.shape == (ranks, want.shape[0])
        np.testing.assert_array_equal(digests, np.broadcast_to(want, digests.shape))


def _fake_mesh(size):
    """A mesh of `size` ranks that is never asked to communicate: the
    checks below raise before any collective."""
    return Mesh(group=None, rank=0, size=size, device=torch.device("cpu"), backend="gloo")


def test_height_that_does_not_divide_raises(port_scene):
    cam = _port_camera(_terrain())
    with pytest.raises(ValueError, match="divide"):
        render_frame_sharded(port_scene, cam, T.RenderConfig(width=16, height=17),
                             _fake_mesh(2))


def test_frame_count_that_does_not_divide_raises(port_scene):
    cams = T.orbit_flythrough(N, 10.0, 5, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        render_flythrough_sharded(port_scene, cams, T.RenderConfig(width=16, height=16),
                                  _fake_mesh(2))
    with pytest.raises(ValueError, match="batched"):
        render_flythrough_sharded(port_scene, frame_camera(cams, 0),
                                  T.RenderConfig(width=16, height=16), _fake_mesh(1))


def test_one_rank_mesh_in_process(port_scene):
    """Without a mesh the sharded renders make and drop a one-rank group."""
    cam = _port_camera(_terrain())
    cfg = T.RenderConfig(width=32, height=16, aux_buffers=True)
    fr = render_frame_sharded(port_scene, cam, cfg)
    want = T.render_frame(port_scene, cam, cfg)
    assert torch.equal(fr.color, want.color) and torch.equal(fr.hit, want.hit)
    assert not torch.distributed.is_initialized()


def test_dryrun_multichip_4():
    out = dryrun_multichip(4)
    assert out["frame"]["hit_diff"] == 0 and len(out["stack_sha"]) == 4
    assert jax.device_count() == 8   # the JAX reference keeps its virtual mesh
