"""Kernel 2: normal and albedo at every hit point.

`shade_pass` launches the CUDA kernel `csrc/shade_pass.cu` for CUDA
tensors and runs its plain torch version, `shade_pass_reference`, for CPU
tensors. It replaces the TPU kernel
`hmrt_tpu/kernels/compact.py::_shade_pass_kernel`.

Inputs: hit, hx, hy i32[P]; fx, fy f32[P] (offsets inside the hit cell);
the scene's gradient planes gx, gy f32 (N, N); the planar albedo
f32 (3, N*N) or None. Outputs: nx, ny, nz, ar, ag, ab f32[P]. A miss gets
the normal (0, 0, 1) and albedo 0.55.
"""

from __future__ import annotations

import torch

from hmrt_tpu_torch.kernels import _build
from hmrt_tpu_torch.shading.shade import bilerp


def shade_pass_reference(hit, hx, hy, fx, fy, gx, gy, albedo=None):
    """The plain torch version, in the kernel's expression order."""
    n = gx.shape[0]
    h = hit != 0
    b = torch.clamp(hy, 0, n - 2) * n + torch.clamp(hx, 0, n - 2)

    def interp(flat):
        return bilerp(flat.index_select(0, b), flat.index_select(0, b + 1),
                      flat.index_select(0, b + n), flat.index_select(0, b + n + 1),
                      fx, fy)

    g_x = interp(gx.reshape(-1))
    g_y = interp(gy.reshape(-1))
    inv = 1.0 / torch.sqrt(g_x * g_x + g_y * g_y + 1.0)
    normal = (torch.where(h, -g_x * inv, 0.0), torch.where(h, -g_y * inv, 0.0),
              torch.where(h, inv, 1.0))
    if albedo is None:
        return (*normal, *(torch.full_like(fx, 0.55) for _ in range(3)))
    return (*normal, *(torch.where(h, interp(albedo[c]), 0.55) for c in range(3)))


def _check_inputs(hit, hx, hy, fx, fy, gx, gy, albedo):
    p = hit.shape[0]
    for name, x, dt in (("hit", hit, torch.int32), ("hx", hx, torch.int32),
                        ("hy", hy, torch.int32), ("fx", fx, torch.float32),
                        ("fy", fy, torch.float32)):
        if x.shape != (p,) or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"{name}: want contiguous {dt} of shape ({p},)")
    n = gx.shape[0]
    for name, x in (("gx", gx), ("gy", gy)):
        if x.shape != (n, n) or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name}: want contiguous f32 ({n}, {n})")
    if n < 2:
        raise ValueError("gradient planes must be at least 2x2")
    if albedo is not None and (albedo.shape != (3, n * n) or albedo.dtype != torch.float32
                               or not albedo.is_contiguous()):
        raise ValueError(f"albedo: want contiguous f32 (3, {n * n})")


def shade_pass(hit, hx, hy, fx, fy, gx, gy, albedo=None):
    """Normals and albedo of every lane: (nx, ny, nz, ar, ag, ab).

    CPU tensors run `shade_pass_reference`; CUDA tensors launch the kernel
    (building it on first use) or raise."""
    planes = [hit, hx, hy, fx, fy, gx, gy] + ([albedo] if albedo is not None else [])
    dev = _build.device_of(planes)
    if dev.type == "cpu":
        return shade_pass_reference(hit, hx, hy, fx, fy, gx, gy, albedo)
    if dev.type != "cuda":
        raise ValueError(f"shade_pass runs on cpu or cuda, not {dev}")
    _check_inputs(hit, hx, hy, fx, fy, gx, gy, albedo)
    lib = _build.library()
    outs = [torch.empty_like(fx) for _ in range(6)]
    with torch.cuda.device(dev):
        err = lib.hmrt_shade_pass(
            *[x.data_ptr() for x in (hit, hx, hy, fx, fy, gx, gy)],
            None if albedo is None else albedo.data_ptr(),
            *[o.data_ptr() for o in outs], hit.shape[0], gx.shape[0],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "shade_pass")
    shade_pass.launches += 1
    return tuple(outs)


shade_pass.launches = 0
