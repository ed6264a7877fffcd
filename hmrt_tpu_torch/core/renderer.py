"""Frame rendering: backend dispatch and the plain torch oracle.

Counterpart of `hmrt_tpu/core/renderer.py`. The oracle is raygen ->
masked-wavefront march -> shading -> Frame in plain torch on any device:
the executable spec that the compact and fused paths with their CUDA
kernels are held against.
"""

from __future__ import annotations

import torch

from hmrt_tpu_torch.config import RenderConfig
from hmrt_tpu_torch.shading import shade as sh
from hmrt_tpu_torch.traversal.march import march_dda, march_maxmip
from hmrt_tpu_torch.types import Camera, Frame, Scene
from hmrt_tpu_torch.utils.profiling import span

SHADOW_EPS = 1e-2


#: "auto" on CUDA: maps with m >= this take the compact path, smaller ones
#: the fused kernel (the JAX package's split, hmrt_tpu/core/renderer.py)
COMPACT_MIN_M = 1024


def choose_backend(device_type: str, m: int, backend: str) -> str:
    """The path `render_frame` takes: "oracle", "compact" or "fused".

      "compact": budgeted march passes with ray sorting
                 (kernels/compact.py);
      "pallas":  the fused tile render (kernels/raycast.py);
      "oracle":  the plain torch pipeline below;
      "auto":    on CUDA, compact for maps with m >= COMPACT_MIN_M and
                 fused for smaller ones; on the CPU, the oracle.
    The kernel paths launch the CUDA kernels on a CUDA scene and run their
    plain torch versions on a CPU scene."""
    if backend == "pallas":
        return "fused"
    if backend in ("oracle", "compact"):
        return backend
    if backend != "auto":
        raise ValueError(f"unknown backend {backend!r}")
    if device_type != "cuda":
        return "oracle"
    return "compact" if m >= COMPACT_MIN_M else "fused"


def render_frame(scene: Scene, camera: Camera, config: RenderConfig):
    """Render one frame on the scene's device, by the path that
    `choose_backend` picks for config.backend. Returns a Frame; on the
    fused path with config.debug_counters, (frame, counts) as
    `kernels/raycast.py::render_frame_fused` returns (the compact and
    oracle paths ignore the flag, as the JAX package's do). The frame is
    the span "hmrt.frame", with the path as its argument
    (utils/profiling.py). On a CUDA scene the compact path replays the
    frame from a CUDA graph once the frame before had the same scene,
    config and camera shapes (kernels/compact.py::FrameGraphs)."""
    path = choose_backend(scene.device.type, scene.m, config.backend)
    with span("hmrt.frame", path):
        if path == "compact":
            from hmrt_tpu_torch.kernels.compact import frame_graphs
            return frame_graphs.render(scene, camera, config)
        if path == "fused":
            from hmrt_tpu_torch.kernels.raycast import render_frame_fused
            return render_frame_fused(scene, camera, config)
        return render_frame_oracle(scene, camera, config)


def _broadcast_eye(eye, p):
    return eye[0].expand(p), eye[1].expand(p), eye[2].expand(p)


def render_frame_oracle(scene: Scene, camera: Camera, config: RenderConfig,
                        row0: int | None = None, full_height: int | None = None) -> Frame:
    """The plain torch oracle pipeline (the reference renderer).
    row0/full_height: render rows [row0, row0 + height) of a
    full_height-row screen, from the same ray bits as those rows of the
    full grid."""
    H, W = config.height, config.width
    eye, dirs = camera.rays(H, W, row0, full_height)
    d = dirs.reshape(-1, 3)
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    ox, oy, oz = _broadcast_eye(eye, dx.shape[0])

    heights_flat = scene.heights.reshape(-1)
    max_steps = config.steps_for(scene.n_cells)
    if config.traversal == "dda":
        res = march_dda(ox, oy, oz, dx, dy, dz, heights_flat, n=scene.n,
                        max_steps=max_steps,
                        cell_intersect=config.cell_intersect,
                        clip=config.clip_box)
    else:
        res = march_maxmip(ox, oy, oz, dx, dy, dz, scene.pyr_flat,
                           heights_flat, n=scene.n, m=scene.m,
                           levels=scene.levels, max_steps=max_steps,
                           cell_intersect=config.cell_intersect,
                           clip=config.clip_box)

    color, depth, normal = shade_hits(scene, config, ox, oy, oz, dx, dy, dz,
                                      res.hit, res.t)
    return Frame(color=color.reshape(H, W, 3),
                 depth=depth.reshape(H, W) if config.aux_buffers else None,
                 normal=normal.reshape(H, W, 3) if config.aux_buffers else None,
                 hit=res.hit.reshape(H, W))


def shade_hits(scene: Scene, config: RenderConfig,
               ox, oy, oz, dx, dy, dz, hit, t):
    """Shade a batch of march results -> (color[P,3], depth[P], normal[P,3])."""
    heights_flat = scene.heights.reshape(-1)
    n = scene.n
    light = scene.light
    lx, ly, lz = light.sun_dir[0], light.sun_dir[1], light.sun_dir[2]

    ts = torch.where(hit, t, 0.0)
    px = ox + ts * dx
    py = oy + ts * dy
    pz = oz + ts * dz

    nx, ny, nz = sh.gradient_normal(heights_flat, n, px, py)
    diff = sh.lambert(nx, ny, nz, lx, ly, lz)

    if config.shadows:
        # a second march toward the sun from just above the hit point; it
        # is always max-mip, so its step cap is the max-mip one even under
        # traversal="dda" (whose 4*N cap has no descend/ascend slack)
        sx = px + lx * SHADOW_EPS + nx * SHADOW_EPS
        sy = py + ly * SHADOW_EPS + ny * SHADOW_EPS
        sz = pz + lz * SHADOW_EPS + nz * SHADOW_EPS
        shadow_cap = config.max_steps or (8 * scene.n_cells + 256)
        p = px.shape[0]
        occ = march_maxmip(
            torch.where(hit, sx, -1e6), torch.where(hit, sy, -1e6), sz,
            lx.expand(p), ly.expand(p), lz.expand(p),
            scene.pyr_flat, heights_flat, n=n, m=scene.m, levels=scene.levels,
            max_steps=shadow_cap, cell_intersect=config.cell_intersect).hit
        diff = torch.where(occ, 0.0, diff)

    if config.texture and scene.albedo is not None:
        ar, ag, ab = sh.sample_albedo(scene.albedo, n, px, py)
    else:
        ar = ag = ab = torch.full_like(px, 0.55)

    amb = config.ambient
    sr, sg, sb = light.sun_color[0], light.sun_color[1], light.sun_color[2]
    r = ar * (amb + diff * sr)
    g = ag * (amb + diff * sg)
    b = ab * (amb + diff * sb)

    if config.shading == "phong":
        spec = sh.phong_specular(nx, ny, nz, lx, ly, lz, -dx, -dy, -dz,
                                 config.shininess)
        if config.shadows:
            spec = torch.where(occ, 0.0, spec)
        ks = config.specular
        r = r + ks * spec * sr
        g = g + ks * spec * sg
        b = b + ks * spec * sb

    if config.fog:
        r, g, b = sh.apply_fog(r, g, b, ts, config.fog_density, light.fog_color)

    skyr, skyg, skyb = sh.sky_color(dz, light.sky_top, light.sky_horizon)
    color = torch.stack([torch.where(hit, r, skyr), torch.where(hit, g, skyg),
                         torch.where(hit, b, skyb)], dim=-1)
    depth = torch.where(hit, t, torch.inf)
    normal = torch.stack([torch.where(hit, nx, 0.0), torch.where(hit, ny, 0.0),
                          torch.where(hit, nz, 0.0)], dim=-1)
    return torch.clamp(color, 0.0, 1.0), depth, normal
