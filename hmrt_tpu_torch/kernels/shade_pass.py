"""Kernel 2: normal and albedo at every hit point.

`shade_pass` launches the CUDA kernel `csrc/shade_pass.cu` for CUDA
tensors and runs its plain torch version, `shade_pass_reference`, for CPU
tensors. It replaces the TPU kernel
`hmrt_tpu/kernels/compact.py::_shade_pass_kernel`.

Inputs: hit, hx, hy i32[P]; fx, fy f32[P] (offsets inside the hit cell);
the scene's per-cell records (api/scene.py shade_records): shade_rec f32
(C, C, 8) of corner gradients and albedo_rec f32 (C, C, 12) of corner RGB
or None, over C = N-1 cells a side. Outputs: nx, ny, nz, ar, ag, ab
f32[P]. A hit cell outside the grid is clamped into it. A miss gets the
normal (0, 0, 1) and albedo 0.55.
"""

from __future__ import annotations

import torch

from hmrt_tpu_torch.kernels import _build
from hmrt_tpu_torch.shading.shade import bilerp

#: floats per cell of each record plane: 4 corners x (gx, gy), x (r, g, b)
SHADE_CH, ALBEDO_CH = 8, 12


def shade_pass_reference(hit, hx, hy, fx, fy, shade_rec, albedo_rec=None):
    """The plain torch version: the same record values in the kernel's
    expression order (bilerp, then 1 / sqrt)."""
    c = shade_rec.shape[0]
    h = hit != 0
    b = torch.clamp(hy, 0, c - 1) * c + torch.clamp(hx, 0, c - 1)

    def interp(rec, k):
        return bilerp(*rec.unbind(1)[k:k + 4], fx, fy)

    g = shade_rec.reshape(c * c, SHADE_CH).index_select(0, b)
    g_x, g_y = interp(g, 0), interp(g, 4)
    inv = 1.0 / torch.sqrt(g_x * g_x + g_y * g_y + 1.0)
    normal = (torch.where(h, -g_x * inv, 0.0), torch.where(h, -g_y * inv, 0.0),
              torch.where(h, inv, 1.0))
    if albedo_rec is None:
        return (*normal, *(torch.full_like(fx, 0.55) for _ in range(3)))
    a = albedo_rec.reshape(c * c, ALBEDO_CH).index_select(0, b)
    return (*normal, *(torch.where(h, interp(a, 4 * k), 0.55) for k in range(3)))


def check_shade_records(shade_rec: torch.Tensor, albedo_rec: torch.Tensor | None) -> None:
    """Raise unless the records are what the kernel reads: contiguous f32
    (C, C, 8) and (C, C, 12) (or None) with C >= 1, each starting on a
    16-byte boundary (the kernel reads them as float4 loads)."""
    c = shade_rec.shape[0] if shade_rec.dim() == 3 else -1
    for name, x, ch in (("shade_rec", shade_rec, SHADE_CH), ("albedo_rec", albedo_rec, ALBEDO_CH)):
        if x is None:
            continue
        if c < 1 or x.shape != (c, c, ch) or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name}: want contiguous f32 (C, C, {ch}) with C = "
                             f"{c if c >= 1 else 'N-1'}, got {x.dtype} {tuple(x.shape)}")
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: the record plane must start on a 16-byte boundary")


def _check_lanes(hit, hx, hy, fx, fy):
    p = hit.shape[0]
    for name, x, dt in (("hit", hit, torch.int32), ("hx", hx, torch.int32),
                        ("hy", hy, torch.int32), ("fx", fx, torch.float32),
                        ("fy", fy, torch.float32)):
        if x.shape != (p,) or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"{name}: want contiguous {dt} of shape ({p},)")


def shade_pass(hit, hx, hy, fx, fy, shade_rec, albedo_rec=None):
    """Normals and albedo of every lane: (nx, ny, nz, ar, ag, ab).

    CPU tensors run `shade_pass_reference`; CUDA tensors launch the kernel
    (building it on first use) or raise."""
    tensors = [hit, hx, hy, fx, fy, shade_rec] + ([albedo_rec] if albedo_rec is not None else [])
    dev = _build.device_of(tensors)
    if dev.type == "cpu":
        return shade_pass_reference(hit, hx, hy, fx, fy, shade_rec, albedo_rec)
    if dev.type != "cuda":
        raise ValueError(f"shade_pass runs on cpu or cuda, not {dev}")
    _check_lanes(hit, hx, hy, fx, fy)
    check_shade_records(shade_rec, albedo_rec)
    lib = _build.library()
    outs = [torch.empty_like(fx) for _ in range(6)]
    with torch.cuda.device(dev):
        err = lib.hmrt_shade_pass(
            *[x.data_ptr() for x in (hit, hx, hy, fx, fy, shade_rec)],
            None if albedo_rec is None else albedo_rec.data_ptr(),
            *[o.data_ptr() for o in outs], hit.shape[0], shade_rec.shape[0],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "shade_pass")
    shade_pass.launches += 1
    return tuple(outs)


shade_pass.launches = 0
