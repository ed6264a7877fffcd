"""The latency of one step of the level-0 tail, measured on the card.

`l0_walk` walks `steps` cells of one ray's level-0 DDA with the tail's step
(`traversal/march.py::l0_step`) and never stops: a cell that hits is taken
again, and a walk past the map's edge reads clamped records. On CUDA
tensors it launches the probe `kernels/csrc/l0_probe.cu`, one lane whose
every record load waits on the previous cell's test; on CPU tensors it runs
the plain loop, `l0_walk_reference`. Over a ray of a tail launch, for the
steps the serial walk under the floor took on it
(`traversal/march.py::l0_min_step` with `hierarchy=False`: a cell a step,
to the floor), the walk ends where that walk ends: the same t, cell, hit
and cell tests.

The probe is on no render path. Its time over `steps` is the latency of
one dependent record load plus one cell test. Over the longest chain of a
tail launch, the serial walk's steps on its longest ray, it is the
chain-of-steps bound of a launch that marches one lane a ray
(kernel_times.py, chip_smoke.py phase 16).
"""

from __future__ import annotations

import torch

from hmrt_tpu_torch.kernels import _build
from hmrt_tpu_torch.kernels.march_pass import check_records
from hmrt_tpu_torch.traversal.intersect import BIG_T, INTERSECTOR_IDS, INTERSECTORS
from hmrt_tpu_torch.traversal.march import (WorkCounter, l0_step, ray_box_range,
                                            ray_inverses, record_corners)
from hmrt_tpu_torch.types import Scene


def l0_walk_reference(rays, state, scene: Scene, *, steps: int,
                      cell_intersect: str = "triangle", clip=None):
    """The plain walk: `l0_step` `steps` times on one ray that never stops.
    Returns (t, t_hit, icx, icy, hit, tests), each of shape (1,)."""
    ox, oy, oz, dx, dy, dz = rays
    _, t, lvl, icx, icy = state
    inv_x, inv_y = ray_inverses(dx, dy)
    _, t1, _ = ray_box_range(ox, oy, dx, dy, float(scene.n - 1), clip)
    ray = (ox, oy, oz, dx, dy, dz, inv_x, inv_y, t1)
    corners = record_corners(scene.heights.reshape(-1), scene.n, scene.m)
    work = WorkCounter(scene.pyr_flat.shape[0], scene.n, t.device, lanes=1)
    live = torch.ones(1, dtype=torch.bool, device=t.device)
    st = dict(t=t, lvl=lvl, icx=icx, icy=icy, alive=live, hit=~live,
              t_hit=torch.full_like(t, BIG_T), hx=icx, hy=icy)
    for _ in range(steps):
        st = l0_step(ray, dict(st, alive=live), corners, scene.pyr_flat[-1], m=scene.m,
                     intersector=INTERSECTORS[cell_intersect], counter=work)
    return (st["t"], st["t_hit"], st["icx"], st["icy"], st["hit"].to(torch.int32),
            work.lane_tests)


def l0_walk(rays, state, scene: Scene, *, steps: int, cell_intersect: str = "triangle",
            clip=None):
    """`steps` steps of the level-0 tail of one ray that never stops
    (module docstring). `rays` and `state` are march_pass's planes of
    length 1. Returns (t, t_hit, icx, icy, hit, tests), each of shape (1,).
    CPU tensors run `l0_walk_reference`; CUDA tensors launch the probe
    (building it on first use) or raise."""
    if rays[0].shape != (1,):
        raise ValueError(f"l0_walk takes one ray, not {tuple(rays[0].shape)}")
    if steps < 0:
        raise ValueError(f"steps {steps} < 0")
    dev = _build.device_of([*rays, *state, scene.corners])
    if dev.type == "cpu":
        return l0_walk_reference(rays, state, scene, steps=steps,
                                 cell_intersect=cell_intersect, clip=clip)
    if dev.type != "cuda":
        raise ValueError(f"l0_walk runs on cpu or cuda, not {dev}")
    check_records(scene.corners, scene.m)
    lo, hi = (0.0, float(scene.n - 1)) if clip is None else clip
    with torch.cuda.device(dev):
        ray = torch.cat([x.to(torch.float32) for x in rays])
        t0 = state[1].to(torch.float32).contiguous()
        cell = torch.cat([state[3], state[4]]).to(torch.int32)
        t_o = torch.empty(2, dtype=torch.float32, device=dev)
        i_o = torch.empty(4, dtype=torch.int32, device=dev)
        err = _build.library().hmrt_l0_probe(
            ray.data_ptr(), t0.data_ptr(), cell.data_ptr(), scene.corners.data_ptr(),
            scene.m, INTERSECTOR_IDS[cell_intersect], steps, float(lo), float(hi),
            t_o.data_ptr(), i_o.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "l0_walk")
    l0_walk.launches += 1
    return t_o[0:1], t_o[1:2], i_o[0:1], i_o[1:2], i_o[2:3], i_o[3:4]


l0_walk.launches = 0
