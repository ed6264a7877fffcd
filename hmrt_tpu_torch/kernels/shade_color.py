"""The colour pass: the Frame's colour, depth and normals of every lane of
a compact frame, from the shade pass's normal and albedo and the shadow
march's hits.

`shade_color` launches the CUDA kernel `csrc/shade_color.cu` for CUDA
tensors and runs its plain torch version, `shade_color_reference`, for CPU
tensors; the fused path's plain version (kernels/raycast.py) runs the
reference too. The JAX package runs these maths as XLA elementwise ops
(`hmrt_tpu/core/renderer.py::shade_hits`), not as a kernel of its own.

Inputs, each contiguous and of shape (P,): hit i32 (the primary march's
hit flag), t_hit f32, the primary direction (dx, dy, dz) f32, the normal
(nx, ny, nz) f32 and the albedo (ar, ag, ab) f32 (the shade pass's
planes), the shadow march's hit plane i32 or None (no shadow rays); the
scene's Light (five f32 (3,) vectors on the
planes' device, which the kernel reads by pointer) and the RenderConfig
(shading, fog, ambient, specular, shininess, fog_density, aux_buffers).
Outputs: color f32 (P, 3) clipped to [0, 1], depth f32 (P,) (+inf on a
miss) and normal f32 (P, 3) ((0, 0, 0) on a miss) with
config.aux_buffers, else None.
"""

from __future__ import annotations

import torch

from hmrt_tpu_torch.config import RenderConfig
from hmrt_tpu_torch.kernels import _build
from hmrt_tpu_torch.shading import shade as sh
from hmrt_tpu_torch.types import Light
from hmrt_tpu_torch.utils.profiling import span


def shade_color_reference(hit_i, t_hit, dirs, normal, albedo, shadow_hit, light: Light,
                          config: RenderConfig):
    """The plain torch version: the colour maths of the oracle
    (core/renderer.py::shade_hits) on the shade pass's planes, in the
    kernel's expression order. Fog runs inside the span "hmrt.shade.fog"."""
    dx, dy, dz = dirs
    nx, ny, nz = normal
    ar, ag, ab = albedo
    hit = hit_i != 0
    lx, ly, lz = light.sun_dir[0], light.sun_dir[1], light.sun_dir[2]
    diff = sh.lambert(nx, ny, nz, lx, ly, lz)
    if shadow_hit is not None:
        occ = shadow_hit != 0
        diff = torch.where(occ, 0.0, diff)

    sr, sg, sb = light.sun_color[0], light.sun_color[1], light.sun_color[2]
    r = ar * (config.ambient + diff * sr)
    g = ag * (config.ambient + diff * sg)
    b = ab * (config.ambient + diff * sb)
    if config.shading == "phong":
        spec = sh.phong_specular(nx, ny, nz, lx, ly, lz, -dx, -dy, -dz,
                                 config.shininess)
        if shadow_hit is not None:
            spec = torch.where(occ, 0.0, spec)
        r = r + config.specular * spec * sr
        g = g + config.specular * spec * sg
        b = b + config.specular * spec * sb
    if config.fog:
        with span("hmrt.shade.fog"):
            r, g, b = sh.apply_fog(r, g, b, torch.where(hit, t_hit, 0.0),
                                   config.fog_density, light.fog_color)
    skyr, skyg, skyb = sh.sky_color(dz, light.sky_top, light.sky_horizon)
    color = torch.stack([torch.where(hit, c, s) for c, s in
                         ((r, skyr), (g, skyg), (b, skyb))], dim=-1)
    color = torch.clamp(color, 0.0, 1.0)
    if not config.aux_buffers:
        return color, None, None
    normal = torch.stack([torch.where(hit, c, 0.0) for c in (nx, ny, nz)], dim=-1)
    return color, torch.where(hit, t_hit, torch.inf), normal


def _check(hit_i, t_hit, dirs, normal, albedo, shadow_hit, light: Light) -> torch.device:
    """The one device of the planes and the light; raises ValueError unless
    each plane is what the kernel reads (contiguous, its dtype, shape (P,))
    and each light vector a contiguous f32 (3,) beside them."""
    if len(dirs) != 3 or len(normal) != 3 or len(albedo) != 3:
        raise ValueError("dirs, normal and albedo take three planes each")
    planes = [("hit", hit_i, torch.int32), ("t_hit", t_hit, torch.float32)]
    planes += [(f"d{c}", x, torch.float32) for c, x in zip("xyz", dirs)]
    planes += [(f"n{c}", x, torch.float32) for c, x in zip("xyz", normal)]
    planes += [(f"a{c}", x, torch.float32) for c, x in zip("rgb", albedo)]
    if shadow_hit is not None:
        planes.append(("shadow_hit", shadow_hit, torch.int32))
    vecs = [(f, getattr(light, f)) for f in ("sun_dir", "sun_color", "sky_top",
                                             "sky_horizon", "fog_color")]
    dev = _build.device_of([x for _, x, _ in planes] + [v for _, v in vecs])
    p = hit_i.shape[0] if hit_i.dim() == 1 else -1
    for name, x, dt in planes:
        if x.shape != (p,) or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"{name}: want contiguous {dt} of shape (P,) = ({p},), got "
                             f"{x.dtype} {tuple(x.shape)}")
    for name, v in vecs:
        if v.shape != (3,) or v.dtype != torch.float32 or not v.is_contiguous():
            raise ValueError(f"light.{name}: want a contiguous f32 (3,), got {v.dtype} "
                             f"{tuple(v.shape)}")
    return dev


def shade_color(hit_i, t_hit, dirs, normal, albedo, shadow_hit, light: Light,
                config: RenderConfig):
    """(color, depth, normal) of every lane (module docstring).

    Raises ValueError on planes the kernel cannot read. CPU tensors then
    run `shade_color_reference`; CUDA tensors launch the kernel (building
    it on first use), with no host copy and no wait."""
    dev = _check(hit_i, t_hit, dirs, normal, albedo, shadow_hit, light)
    if dev.type == "cpu":
        return shade_color_reference(hit_i, t_hit, dirs, normal, albedo, shadow_hit, light,
                                     config)
    if dev.type != "cuda":
        raise ValueError(f"shade_color runs on cpu or cuda, not {dev}")
    p = hit_i.shape[0]
    aux = config.aux_buffers
    color = torch.empty((p, 3), dtype=torch.float32, device=dev)
    depth = torch.empty((p,), dtype=torch.float32, device=dev) if aux else None
    nrm = torch.empty((p, 3), dtype=torch.float32, device=dev) if aux else None
    lib = _build.library()

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(dev):
        err = lib.hmrt_shade_color(
            hit_i.data_ptr(), t_hit.data_ptr(), *map(ptr, dirs), *map(ptr, normal),
            *map(ptr, albedo), ptr(shadow_hit),
            *(v.data_ptr() for v in (light.sun_dir, light.sun_color, light.sky_top,
                                     light.sky_horizon, light.fog_color)),
            color.data_ptr(), ptr(depth), ptr(nrm), p,
            int(config.shading == "phong"), int(config.fog), config.ambient,
            config.specular, config.shininess, config.fog_density,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "shade_color")
    return color, depth, nrm
