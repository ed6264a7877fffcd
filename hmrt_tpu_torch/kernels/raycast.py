"""Kernel 3: the fused render, each pixel's whole work in one kernel.

`render_frame_fused` launches the CUDA kernel `csrc/render_tile.cu` for a
CUDA scene and runs its plain torch version, `render_frame_fused_reference`,
for a CPU scene. It replaces the TPU kernel
`hmrt_tpu/kernels/raycast.py::_render_kernel` (entry `render_frame_pallas`):
raygen from a packed params vector, the unbudgeted march from the pyramid
top with the sky early-out, normal and albedo at the hit, a shadow march
from the hit cell, Lambert or Phong, fog and sky. `row0` and
`full_height` place the render as a band of rows of a taller screen.

Both marches are the max-mip march above the terrain and K1's min walk
under it (`traversal/march.py::fused_step`): a ray that enters the map's
wall below the surface passes whole blocks of the min pyramid
(`Scene.pyr_min_flat`) and ends under the map's lowest height, where the
max-mip march alone (the TPU kernel's march) walks it cell by cell. The
hits are the max-mip march's, bit for bit; `fused_witness_planes` renders
by that march alone, to hold them to it.

The TPU kernel's Mosaic schedule (coarse VMEM buffer, column-cascade demand
loop, DMA semaphores, n_col, the ascent cap, tile_h and the HMRT_*
environment knobs) is not ported: it only decided which rays step when.
"""

from __future__ import annotations

import torch

from hmrt_tpu_torch.config import RenderConfig
from hmrt_tpu_torch.kernels import _build
from hmrt_tpu_torch.kernels.compact import (empty_results, init_state, shade_frame,
                                            to_frame)
from hmrt_tpu_torch.kernels.march_pass import (UNBUDGETED, check_counts, check_min_pyramid,
                                               check_records, fused_march_reference,
                                               march_pass_reference)
from hmrt_tpu_torch.kernels.shade_color import shade_color_reference
from hmrt_tpu_torch.kernels.shade_pass import shade_pass_reference
from hmrt_tpu_torch.traversal.intersect import INTERSECTOR_IDS
from hmrt_tpu_torch.traversal.march import WorkCounter
from hmrt_tpu_torch.types import Camera, Frame, Scene, recip_f32, sqrt_f32, tan_half
from hmrt_tpu_torch.utils.profiling import span

# params vector layout (f32[32]), as hmrt_tpu/kernels/raycast.py
_P_EYE = 0        # 0-2
_P_RIGHT = 3      # 3-5
_P_UP = 6         # 6-8
_P_FWD = 9        # 9-11
_P_TANHALF = 12
_P_ASPECT = 13
_P_SUN = 14       # 14-16
_P_SUNCOL = 17    # 17-19
_P_SKYTOP = 20    # 20-22
_P_SKYHOR = 23    # 23-25
_P_FOGCOL = 26    # 26-28
_P_GMAX = 29
_P_ROW0 = 30      # first screen row of this band
N_PARAMS = 32


def make_params(scene: Scene, camera: Camera, config: RenderConfig, row0=None,
                full_height: int | None = None) -> torch.Tensor:
    """Camera and light scalars packed into the kernel's f32[32] params
    vector, with the aspect and row0 set as `render_frame_pallas` sets
    them. On the scene's device."""
    right, up, fwd = camera.basis()
    light = scene.light
    fh = full_height or config.height

    def scalar(v):
        return torch.tensor([v], dtype=torch.float32, device=scene.device)

    vals = torch.cat([camera.eye, right, up, fwd, tan_half(camera.fov_y)[None],
                      scalar(config.width / fh), light.sun_dir, light.sun_color,
                      light.sky_top, light.sky_horizon, light.fog_color,
                      scene.pyr_flat[-1:], scalar(0.0 if row0 is None else row0)])
    return torch.cat([vals, torch.zeros(N_PARAMS - vals.shape[0], dtype=torch.float32,
                                        device=scene.device)])


def params_rays(params: torch.Tensor, height: int, width: int, full_height: int):
    """Primary ray planes (ox, oy, oz, dx, dy, dz), each f32[H*W], from
    the params vector: the kernel's raygen in torch. Equal, bit for bit,
    to `Camera.rays` of the camera the params were made from."""
    P = params
    dev = P.device
    jj = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) \
        * recip_f32(width) * 2.0 - 1.0
    rr = torch.arange(height, dtype=torch.float32, device=dev) + P[_P_ROW0]
    ii = 1.0 - (rr + 0.5) * recip_f32(full_height) * 2.0
    sx = (jj * P[_P_TANHALF] * P[_P_ASPECT])[None, :]    # (1, W)
    sy = (ii * P[_P_TANHALF])[:, None]                   # (H, 1)
    dx, dy, dz = (P[_P_FWD + c] + sx * P[_P_RIGHT + c] + sy * P[_P_UP + c]
                  for c in range(3))
    nrm = sqrt_f32(dx * dx + dy * dy + dz * dz)
    p = height * width
    return (tuple(P[_P_EYE + c].expand(p).contiguous() for c in range(3))
            + tuple((v / nrm).reshape(p) for v in (dx, dy, dz)))


def fused_reference_planes(scene: Scene, camera: Camera, config: RenderConfig,
                           row0=None, full_height: int | None = None, counter=None,
                           shadow_counter=None, witness: bool = False):
    """The plain version of the kernel: flat (color[P,3], depth[P],
    normal[P,3], hit[P] bool, cell[P,2]) of the frame or band (depth and
    normal None without config.aux_buffers), both marches
    by `fused_march_reference`. `counter` (a traversal.march.WorkCounter)
    records the work of both marches, or of the primary march alone when
    `shadow_counter` takes the shadow march's. `witness`: march by the
    max-mip march alone (`march_pass_reference`, unbudgeted), the plain
    version of `fused_witness_planes`."""
    H, W = config.height, config.width
    fh = full_height or H
    params = make_params(scene, camera, config, row0, fh)
    rays = params_rays(params, H, W, fh)
    kw = dict(n=scene.n, m=scene.m, levels=scene.levels,
              cell_intersect=config.cell_intersect, clip=config.clip_box)

    def march(rays_, state, work):
        res = empty_results(rays_[0].shape[0], rays_[0].device)
        if witness:
            return march_pass_reference(rays_, state, res, scene.pyr_flat, scene.heights,
                                        budget=UNBUDGETED, counter=work, **kw)[1]
        return fused_march_reference(rays_, state, res, scene.pyr_flat, scene.heights,
                                     scene.pyr_min_flat, counter=work, **kw)[1]

    state0 = init_state(rays, None, params[_P_GMAX], n=scene.n, m=scene.m,
                        levels=scene.levels, clip=config.clip_box)
    hit_i, t_hit, hx, hy = march(rays, state0, counter)
    color, depth, normal, hit = shade_frame(
        scene, config, rays, hit_i, t_hit, hx, hy, shade=shade_pass_reference,
        color=shade_color_reference,
        shadow_hits=lambda srays, sstate: march(srays, sstate, shadow_counter or counter)[0])
    return color, depth, normal, hit, torch.stack([hx, hy], dim=-1)


def render_frame_fused_reference(scene: Scene, camera: Camera, config: RenderConfig,
                                 row0=None, full_height: int | None = None):
    """The plain torch version of the fused render: a Frame, or with
    config.debug_counters (frame, counts) as `render_frame_fused` returns."""
    works = _pixel_counters(scene, config) if config.debug_counters else ()
    frame = to_frame(config, *fused_reference_planes(scene, camera, config, row0,
                                                     full_height, *works)[:4])
    return (frame, _count_planes(works, config)) if works else frame


def _pixel_counters(scene: Scene, config: RenderConfig) -> list:
    """Per-pixel WorkCounters of the primary and the shadow march."""
    return [WorkCounter(scene.pyr_flat.shape[0], scene.n, scene.device,
                        lanes=config.height * config.width) for _ in range(2)]


def _count_planes(works, config: RenderConfig) -> tuple:
    """The four int32 (H, W) counter planes from `_pixel_counters`."""
    return tuple(x.reshape(config.height, config.width)
                 for w in works for x in (w.lane_steps, w.lane_tests))


def _check_inputs(scene: Scene, camera: Camera, config: RenderConfig):
    n = scene.n
    check_records(scene.corners, scene.m)
    planes = [scene.pyr_flat, scene.gx, scene.gy]
    if config.texture and scene.albedo is not None:
        planes.append(scene.albedo)
    for x in planes:
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("scene planes must be contiguous f32")
    if scene.gx.shape != (n, n) or scene.gy.shape != (n, n) or n < 2:
        raise ValueError(f"scene planes must be ({n}, {n})")
    if scene.m.bit_length() != scene.levels or n - 1 > scene.m:
        raise ValueError(f"inconsistent geometry n={n} m={scene.m} levels={scene.levels}")
    if camera.eye.device != scene.device:
        raise ValueError(f"camera on {camera.eye.device}, scene on {scene.device}")


def fused_planes(scene: Scene, camera: Camera, config: RenderConfig, row0=None,
                 full_height: int | None = None, cells: bool = False,
                 counts: torch.Tensor | None = None):
    """(color (H,W,3), depth (H,W) or None, normal (H,W,3) or None,
    hit (H,W) bool, cell (H,W,2) or None) of the fused render. Depth and
    normals come with config.aux_buffers, the hit cells with `cells`.
    `counts`, an int32 (4, H, W) output, takes each pixel's primary steps,
    primary cell tests, shadow steps and shadow cell tests (the kernel's
    counting instance; the timed path passes none).

    A CPU scene runs the plain version; a CUDA scene launches the kernel
    (building it on first use) or raises. The kernel reads the scene's
    corner records and both pyramids (a scene without its min pyramid
    raises), the plain version its pyramids and heights."""
    H, W = config.height, config.width
    dev = scene.device
    if counts is not None:
        check_counts(counts, (4, H, W), dev)
    if dev.type == "cpu":
        works = () if counts is None else _pixel_counters(scene, config)
        planes = fused_reference_planes(scene, camera, config, row0, full_height, *works)
        if works:
            counts.copy_(torch.stack(_count_planes(works, config)))
        return _shaped(planes, config, cells)
    if scene.pyr_min_flat is None:
        raise ValueError("the fused kernel reads the min pyramid: the scene has none "
                         "(Scene.pyr_min_flat)")
    check_min_pyramid(scene.pyr_min_flat, scene.m)
    return _launch(scene, camera, config, row0, full_height, cells, counts,
                   scene.pyr_min_flat)


def fused_witness_planes(scene: Scene, camera: Camera, config: RenderConfig, row0=None,
                         full_height: int | None = None):
    """`fused_planes(..., cells=True)` by the max-mip march alone, the
    march the fused kernel had before its min walk under the terrain: the
    witness that the tests and chip_smoke.py hold the kernel's hit, depth,
    hit cells and colour to, bit for bit. A CUDA scene launches the kernel
    without the min pyramid (which passes under nothing); a CPU scene runs
    the plain version with `witness=True`. No render path calls it."""
    if scene.device.type == "cpu":
        return _shaped(fused_reference_planes(scene, camera, config, row0, full_height,
                                              witness=True), config, True)
    return _launch(scene, camera, config, row0, full_height, True, None, None)


def _shaped(planes, config: RenderConfig, cells: bool):
    """The plain version's flat planes in the shapes `fused_planes` returns."""
    H, W = config.height, config.width
    color, depth, normal, hit, cell = planes
    aux = config.aux_buffers
    return (color.reshape(H, W, 3), depth.reshape(H, W) if aux else None,
            normal.reshape(H, W, 3) if aux else None, hit.reshape(H, W),
            cell.reshape(H, W, 2) if cells else None)


def _launch(scene: Scene, camera: Camera, config: RenderConfig, row0, full_height, cells,
            counts, pyr_min):
    """One launch of the kernel on a CUDA scene; `pyr_min` None: the
    witness march. Spans "hmrt.fused.params" (the checks and
    `make_params`) and "hmrt.fused.kernel" (the outputs and the launch)."""
    H, W = config.height, config.width
    fh = full_height or H
    dev = scene.device
    aux = config.aux_buffers
    if dev.type != "cuda":
        raise ValueError(f"render_frame_fused runs on cpu or cuda, not {dev}")
    with span("hmrt.fused.params"):
        _check_inputs(scene, camera, config)
        if row0 is not None and not 0 <= row0 <= fh - H:
            raise ValueError(f"row band [{row0}, {row0 + H}) outside a {fh}-row screen")
        params = make_params(scene, camera, config, row0, fh)
    with span("hmrt.fused.kernel"):
        lib = _build.library()
        color = torch.empty((H, W, 3), dtype=torch.float32, device=dev)
        hit = torch.empty((H, W), dtype=torch.int32, device=dev)
        depth = torch.empty((H, W), dtype=torch.float32, device=dev) if aux else None
        normal = torch.empty((H, W, 3), dtype=torch.float32, device=dev) if aux else None
        cell = torch.empty((H, W, 2), dtype=torch.int32, device=dev) if cells else None
        albedo = scene.albedo if config.texture else None
        lo, hi = (0.0, float(scene.n - 1)) if config.clip_box is None else config.clip_box

        def ptr(x):
            return None if x is None else x.data_ptr()

        with torch.cuda.device(dev):
            next_pixel = torch.zeros(1, dtype=torch.int32, device=dev)
            err = lib.hmrt_render_tile(
                params.data_ptr(), scene.pyr_flat.data_ptr(), scene.corners.data_ptr(),
                ptr(pyr_min), scene.gx.data_ptr(), scene.gy.data_ptr(), ptr(albedo),
                color.data_ptr(), hit.data_ptr(), ptr(depth), ptr(normal), ptr(cell), H, W,
                fh, scene.n, scene.m, scene.levels, INTERSECTOR_IDS[config.cell_intersect],
                int(config.shading == "phong"), int(config.shadows), int(config.fog),
                config.ambient, config.specular, config.shininess, config.fog_density,
                float(lo), float(hi), next_pixel.data_ptr(), ptr(counts),
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "render_tile")
        render_frame_fused.launches += 1
        return color, depth, normal, hit != 0, cell


def render_frame_fused(scene: Scene, camera: Camera, config: RenderConfig, row0=None,
                       full_height: int | None = None):
    """Render through the fused kernel (CUDA scene) or its plain version
    (CPU scene). `row0`/`full_height` render rows [row0, row0 + height) of
    a full_height-row screen.

    Returns a Frame, or with config.debug_counters (frame, counts): four
    int32 (H, W) planes of each pixel's primary steps, primary cell tests,
    shadow steps and shadow cell tests, from the kernel's counting instance
    (`fused_planes(..., counts=)`)."""
    counts = None
    if config.debug_counters:
        counts = torch.empty((4, config.height, config.width), dtype=torch.int32,
                             device=scene.device)
    color, depth, normal, hit, _ = fused_planes(scene, camera, config, row0,
                                                full_height, counts=counts)
    frame = Frame(color=color, depth=depth, normal=normal, hit=hit)
    return frame if counts is None else (frame, tuple(counts.unbind(0)))


render_frame_fused.launches = 0
