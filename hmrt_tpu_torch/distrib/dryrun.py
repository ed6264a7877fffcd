"""Rank functions for multi-rank runs, and the multi-rank dry run.

`spawn` (distrib/mesh.py) pickles a rank function by name, so a spawned
rank imports only the module that defines it: these live in the package,
not in a test or script that imports more (a JAX reference, say).

`dryrun_multichip(n)` is the counterpart of
`__graft_entry__.py::dryrun_multichip`: n ranks render a 64^2 band-sharded
frame and an n-frame flythrough, each equal to the one-rank render.
"""

from __future__ import annotations

import dataclasses
import hashlib
from datetime import timedelta

import numpy as np
import torch

from hmrt_tpu_torch.api.flythrough import frame_camera, orbit_flythrough
from hmrt_tpu_torch.api.scene import make_scene
from hmrt_tpu_torch.config import RenderConfig
from hmrt_tpu_torch.core.renderer import render_frame
from hmrt_tpu_torch.distrib.mesh import (gather_rows, render_flythrough_sharded,
                                         render_frame_sharded, replicate_scene, spawn)
from hmrt_tpu_torch.types import Camera, Scene

_PLANES = ("heights", "pyr_flat", "pyr_min_flat", "corners", "gx", "gy", "albedo", "shade_rec",
           "albedo_rec")


def scene_digest(scene: Scene) -> torch.Tensor:
    """Per plane (and the light), the sum of its f32 bit patterns as
    int64: equal digests on two ranks mean equal bits, for all practical
    purposes."""
    xs = [getattr(scene, k) for k in _PLANES] + [
        getattr(scene.light, f.name) for f in dataclasses.fields(scene.light)]
    return torch.stack([torch.zeros((), dtype=torch.int64, device=scene.device) if x is None
                        else x.contiguous().view(torch.int32).sum(dtype=torch.int64)
                        for x in xs])


def frame_digest(*planes) -> str:
    """sha256 of the planes' bytes, in order (host copies)."""
    h = hashlib.sha256()
    for x in planes:
        h.update(x.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def compare_frames(got, want) -> dict:
    """hit, depth and colour of a sharded render against the one-rank one.
    Depth and normal only where both frames carry them."""
    out = {"hit_diff": int((got.hit != want.hit).sum()),
           "color_max_err": float((got.color - want.color).abs().max())}
    if got.depth is not None and want.depth is not None:
        out["depth_diff"] = int((got.depth != want.depth).sum())
        out["normal_max_err"] = float((got.normal - want.normal).abs().max())
    return out


def render_sharded_rank(mesh, source, config: RenderConfig, camera=None, orbit=None,
                        keep: bool = True) -> dict:
    """One rank's part of a sharded run, called by every rank together.

    source: an (N, N) height array, or the path of a .npy file that rank 0
    alone reads; with config.texture the bench albedo of it
    (bench/configs.py::bench_albedo). Rank 0 builds the scene on its device
    and `replicate_scene` gives it to the others.
    camera: (eye, target, fov_y_deg) for `render_frame_sharded`, held
    against `render_frame` of the same scene on the rank; orbit: (frames,
    count, zmax) for `render_flythrough_sharded` of the first `count`
    frames of an orbit over the map, held frame by frame against
    `render_frame`.
    Rank 0 returns the scene digests of every rank, the comparisons, the
    sha256 of the gathered planes and, with `keep`, the gathered planes as
    numpy arrays."""
    from hmrt_tpu_torch.bench.configs import bench_albedo
    scene = None
    if mesh.rank == 0:
        terr = np.load(source) if isinstance(source, str) else np.asarray(source, np.float32)
        albedo = bench_albedo(terr) if config.texture else None
        scene = make_scene(terr, albedo=albedo, device=mesh.device)
    scene = replicate_scene(scene, mesh)
    out = {"scene_digests": gather_rows(scene_digest(scene)[None], mesh).cpu().numpy()}
    dev = mesh.device
    if camera is not None:
        eye, target, fov = camera
        cam = Camera.create(eye=eye, target=target, fov_y_deg=fov, device=dev)
        fr = render_frame_sharded(scene, cam, config, mesh)
        if mesh.rank == 0:
            out["frame"] = compare_frames(fr, render_frame(scene, cam, config))
            out["frame_sha"] = frame_digest(fr.color, fr.hit)
            if keep:
                out["color"], out["hit"] = fr.color.cpu().numpy(), fr.hit.cpu().numpy()
                if config.aux_buffers:
                    out["depth"], out["normal"] = fr.depth.cpu().numpy(), fr.normal.cpu().numpy()
    if orbit is not None:
        frames, count, zmax = orbit
        cams = orbit_flythrough(scene.n, zmax, frames, device=dev)
        cams = Camera(**{f.name: getattr(cams, f.name)[:count] for f in dataclasses.fields(cams)})
        stack = render_flythrough_sharded(scene, cams, config, mesh)
        if mesh.rank == 0:
            refs = [render_frame(scene, frame_camera(cams, i), config).color
                    for i in range(count)]
            out["stack_max_err"] = [float((stack[i] - r).abs().max())
                                    for i, r in enumerate(refs)]
            out["stack_sha"] = [frame_digest(s) for s in stack]
            if keep:
                out["stack"] = stack.cpu().numpy()
    return out


def render_sharded_jobs(mesh, jobs: list) -> list | None:
    """`render_sharded_rank(mesh, **job)` for each job in turn, on every
    rank; rank 0 returns the list of its results."""
    outs = [render_sharded_rank(mesh, **job) for job in jobs]
    return outs if mesh.rank == 0 else None


def _dryrun_rank(mesh, n_devices: int):
    from hmrt_tpu_torch.io.heightmap import procedural_terrain
    terr = procedural_terrain(64, seed=3)
    cfg = RenderConfig(width=64, height=8 * n_devices, traversal="maxmip",
                       shading="phong", shadows=True, aux_buffers=True)
    eye = (32.0, -16.0, float(terr.max()) + 8.0)
    target = (32.0, 32.0, float(terr.mean()))
    fcfg = RenderConfig(width=32, height=24, shading="phong", shadows=True)
    band = render_sharded_rank(mesh, terr, cfg, camera=(eye, target, 60.0), keep=False)
    fly = render_sharded_rank(mesh, terr, fcfg, orbit=(n_devices, n_devices, float(terr.max())),
                              keep=False)
    if mesh.rank:
        return None
    return {**band, **{k: fly[k] for k in ("stack_max_err", "stack_sha")}}


def dryrun_multichip(n_devices: int) -> dict:
    """Spawn n gloo ranks on the CPU that render the 64^2 band-sharded
    frame (64 x 8n, Phong, shadows, aux) and the n-frame orbit flythrough,
    each held against the one-rank render on the rank (hit mask and depth
    equal, colour within 1e-5, the JAX dry run's bars). Raises if a rank
    fails, hangs past 120 s, or a check does not hold; returns rank 0's
    comparisons."""
    out = spawn(_dryrun_rank, n_devices, args=(n_devices,), backend="gloo",
                devices=["cpu"] * n_devices, timeout=timedelta(seconds=60),
                join_timeout=120, threads=1)
    digests = out["scene_digests"]
    if not (digests == digests[0]).all():
        raise AssertionError("replicate_scene gave the ranks different scenes")
    f = out["frame"]
    if f["hit_diff"] or f["depth_diff"] or f["color_max_err"] > 1e-5:
        raise AssertionError(f"sharded frame differs from the one-rank render: {f}")
    if max(out["stack_max_err"]) > 1e-5:
        raise AssertionError(f"frame-sharded flythrough differs: {out['stack_max_err']}")
    return out
