"""Kernel 1: one budgeted max-mip march pass over flat ray-state planes.

`march_pass` launches the CUDA kernel `csrc/march_pass.cu` for CUDA
tensors and runs its plain torch version, `march_pass_reference`, for CPU
tensors. It replaces the TPU kernel
`hmrt_tpu/kernels/compact.py::_march_pass_kernel`.

Planes, each 1-D of length P (the JAX package's order and dtypes):
  rays    (ox, oy, oz, dx, dy, dz)           f32
  state   (alive, t, lvl, icx, icy)          i32, f32, i32, i32, i32
  results (hit, t_hit, hx, hy)               i32, f32, i32, i32
Every alive ray takes up to `budget` steps of the max-mip march; the
budget is per ray, so a pass with budget b followed by one with budget c
equals one pass with budget b + c, and UNBUDGETED resolves every ray. The
kernel relies on it twice over: its persistent warps march each ray in
chunks and take the rays in whatever order lanes come free.

The kernel reads level 0 from the scene's corner records (`Scene.corners`)
and the levels above from `pyr_flat`, and the exact level-0 tail also the
min pyramid (`Scene.pyr_min_flat`); the plain version reads `pyr_flat` and
`heights`, the function the records are held against (and the min pyramid
when it is given, else builds it from `heights`).

Tail modes, as the TPU kernel's `l0_only` and `relax` arguments: with
`l0_only` every ray is taken as a level-0 ray (the caller has forced it
there, kernels/compact.py::force_level0) and marches the level-0 DDA with
the exact test, with `l0_step`'s hits (`traversal/march.py::l0_min_step`:
a ray under a block's lowest corner passes the block untested, one under
the map's lowest height ends); with `relax=k` as well, the relaxed stride
tail (`l0_step_relaxed`), defined only unbudgeted, as in the JAX package.
`l0_only` may also be a 0-dim tensor on the planes' device, a flag that
the kernel reads on the card: when it is false the pass is the max-mip
pass (the "auto" tail decides it on the device, with no host wait).

The kernel marches the level-0 tail with one lane a ray, passing under
whole blocks ("auto", the default, and 1), or when asked (`group=32`) with
a group of 32 lanes a ray, testing 32 consecutive cells of the ray at once
and ending only under the floor (`l0_min_step(hierarchy=False)`; faster
only where a few rays walk long level-0 chains above the terrain,
march_pass.cu). Both give the same hits; a ray that ends as a miss ends in
another state, after other counts, so the plain version takes the group
too. `march_pass.mode_launches` counts, on the card, which march each
launch ran.
"""

from __future__ import annotations

import torch

from hmrt_tpu_torch.core.pyramid import build_min_pyramid_flat, flat_size, min_flat_size
from hmrt_tpu_torch.kernels import _build
from hmrt_tpu_torch.traversal.intersect import INTERSECTORS, INTERSECTOR_IDS, SURFACES
from hmrt_tpu_torch.traversal.march import (WorkCounter, below_margins, l0_min_step,
                                            l0_step_relaxed, maxmip_step, ray_box_range,
                                            ray_inverses, record_corners, relaxed_planes,
                                            run_masked)

UNBUDGETED = 1 << 22
#: the kernel's mode argument: the max-mip march, the exact level-0 tail,
#: the relaxed tail (march_pass.cu MODE)
MODE_MAXMIP, MODE_L0, MODE_RELAX = 0, 1, 2
#: the level-0 tail's lanes a ray that a caller may force: one, or a group
#: (march_pass.cu GROUP)
GROUPS = (1, 32)
#: what a launch ran, the slots of the kernel's tally (march_pass.cu RAN_*)
TALLY_KEYS = ("maxmip", "l0", "l0_g32", "relax")
STATE_DTYPES = (torch.int32, torch.float32, torch.int32, torch.int32, torch.int32)
RESULT_DTYPES = (torch.int32, torch.float32, torch.int32, torch.int32)


def check_tail(l0_only, relax: int, budget: int, group="auto") -> None:
    """Raise unless (l0_only, relax, budget, group) is a pass the kernel
    defines: relax >= 0, and relax > 0 only for an unbudgeted level-0 tail;
    group "auto", or one of GROUPS for the exact level-0 tail."""
    tail = isinstance(l0_only, torch.Tensor) or bool(l0_only)
    if relax < 0:
        raise ValueError(f"relax {relax} < 0")
    if relax and not tail:
        raise ValueError("relax > 0 is a mode of the level-0 tail: it needs l0_only")
    if relax and budget != UNBUDGETED:
        raise ValueError(f"a relaxed pass is defined only unbudgeted, not at budget {budget}")
    if group != "auto" and (group not in GROUPS or not tail or relax):
        raise ValueError(f"group {group!r}: want 'auto', or one of {GROUPS} for the exact "
                         "level-0 tail (l0_only, relax 0)")


class LaunchTally:
    """Launches of the march kernel by the march each one ran (TALLY_KEYS),
    counted on the card by the kernel itself: an "auto" tail whose flag
    was false ran "maxmip", and an exact level-0 tail ran "l0" (one lane a
    ray) or "l0_g32" (32 lanes a ray, when the caller asked for it).
    `read()` waits for the card."""

    def __init__(self):
        self._slots = {}  # device -> int32 (len(TALLY_KEYS),)

    def slots(self, dev) -> torch.Tensor:
        """The device's tally, made at its first launch."""
        if dev not in self._slots:
            self._slots[dev] = torch.zeros(len(TALLY_KEYS), dtype=torch.int32, device=dev)
        return self._slots[dev]

    def reset(self) -> None:
        for t in self._slots.values():
            t.zero_()

    def read(self) -> dict:
        counts = dict.fromkeys(TALLY_KEYS, 0)
        for t in self._slots.values():
            for key, v in zip(TALLY_KEYS, t.tolist()):
                counts[key] += v
        return counts


def march_pass_reference(rays, state, results, pyr_flat, heights, *, n: int,
                         m: int, levels: int, budget: int,
                         cell_intersect: str = "triangle", clip=None,
                         counter: WorkCounter | None = None,
                         l0_only=False, relax: int = 0, group="auto", pyr_min=None):
    """The plain torch version: the masked step loop of
    `traversal/march.py`, at most `budget` steps: `maxmip_step`, or with
    `l0_only` `l0_min_step` (as the kernel marches one lane a ray, for
    `group` 1 or "auto"; its lane groups' walk for 32), or with `relax` as
    well `l0_step_relaxed`. `pyr_min`: the min pyramid, or None to build
    it from `heights`. `counter` records the work done."""
    check_tail(l0_only, relax, budget, group)
    if isinstance(l0_only, torch.Tensor):
        l0_only = bool(l0_only)
    ox, oy, oz, dx, dy, dz = rays
    alive, t, lvl, icx, icy = state
    hit, t_hit, hx, hy = results
    inv_x, inv_y = ray_inverses(dx, dy)
    _, t1, _ = ray_box_range(ox, oy, dx, dy, float(n - 1), clip)
    ray = (ox, oy, oz, dx, dy, dz, inv_x, inv_y, t1)
    gmax = pyr_flat[-1]
    heights_flat = heights.reshape(-1)
    intersector = INTERSECTORS[cell_intersect]
    st = dict(t=t, lvl=lvl, icx=icx, icy=icy, alive=alive != 0, hit=hit != 0,
              t_hit=t_hit, hx=hx, hy=hy)
    if not l0_only:
        def step(s):
            return maxmip_step(ray, s, pyr_flat, heights_flat, gmax, n=n, m=m,
                               levels=levels, intersector=intersector, counter=counter)
    elif not relax:
        corners = record_corners(heights_flat, n, m)
        if pyr_min is None:
            pyr_min = build_min_pyramid_flat(heights)
        below = below_margins(ray, pyr_min[-1], gmax, m=m, cell_intersect=cell_intersect)

        def step(s):
            return l0_min_step(ray, s, corners, pyr_flat, pyr_min, gmax, below, m=m,
                               levels=levels, intersector=intersector, counter=counter,
                               hierarchy=group != 32)
    else:
        corners = record_corners(heights_flat, n, m)
        st.update(relaxed_planes(t))

        def step(s):
            return l0_step_relaxed(ray, s, corners, gmax, m=m, intersector=intersector,
                                   surface=SURFACES[cell_intersect], stride=relax,
                                   counter=counter)
    st = run_masked(step, st, budget)
    return ((st["alive"].to(torch.int32), st["t"], st["lvl"], st["icx"], st["icy"]),
            (st["hit"].to(torch.int32), st["t_hit"], st["hx"], st["hy"]))


def check_records(corners: torch.Tensor, m: int) -> None:
    """Raise unless `corners` is the record plane the kernels read: a
    contiguous f32 (m, m, 4) whose start is 16-byte aligned (each record is
    one float4 load)."""
    if corners.shape != (m, m, 4) or corners.dtype != torch.float32 \
            or not corners.is_contiguous():
        raise ValueError(f"corners: want contiguous f32 ({m}, {m}, 4), got "
                         f"{corners.dtype} {tuple(corners.shape)}")
    if corners.data_ptr() % 16:
        raise ValueError("corners: the record plane must start on a 16-byte boundary")


def check_counts(counts: torch.Tensor, shape: tuple, dev) -> None:
    """Raise unless `counts` is a contiguous int32 plane of `shape` on `dev`."""
    if counts.shape != shape or counts.dtype != torch.int32 \
            or not counts.is_contiguous() or counts.device != dev:
        raise ValueError(f"counts: want contiguous int32 {shape} on {dev}, got "
                         f"{counts.dtype} {tuple(counts.shape)} on {counts.device}")


def check_min_pyramid(pyr_min: torch.Tensor, m: int) -> None:
    """Raise unless `pyr_min` is the min pyramid the level-0 tail reads: a
    contiguous f32 (min_flat_size(m),)."""
    size = min_flat_size(m)
    if pyr_min.shape != (size,) or pyr_min.dtype != torch.float32 \
            or not pyr_min.is_contiguous():
        raise ValueError(f"pyr_min: want contiguous f32 ({size},) for m={m}, got "
                         f"{pyr_min.dtype} {tuple(pyr_min.shape)}")


def _check_inputs(rays, state, results, pyr_flat, corners, n, m, levels, budget):
    p = rays[0].shape[0]
    dtypes = (torch.float32,) * 6 + STATE_DTYPES + RESULT_DTYPES
    for i, (x, dt) in enumerate(zip((*rays, *state, *results), dtypes)):
        if x.shape != (p,) or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"plane {i}: want contiguous {dt} of shape ({p},), got "
                             f"{x.dtype} {tuple(x.shape)}")
    check_records(corners, m)
    if pyr_flat.shape != (flat_size(m),) or pyr_flat.dtype != torch.float32 \
            or not pyr_flat.is_contiguous():
        raise ValueError(f"pyr_flat: want contiguous f32 ({flat_size(m)},) for m={m}")
    if levels != m.bit_length() or n - 1 > m or n < 2:
        raise ValueError(f"inconsistent geometry n={n} m={m} levels={levels}")
    if not 0 <= budget <= UNBUDGETED:
        raise ValueError(f"budget {budget} outside [0, {UNBUDGETED}]")
    if p:  # the kernel shifts by the level and indexes the pyramid with it
        lo, hi = (int(v) for v in torch.aminmax(state[2]))
        if lo < 0 or hi >= levels:
            raise ValueError(f"levels in [{lo}, {hi}] outside [0, {levels - 1}]")


def march_pass(rays, state, results, pyr_flat, heights, corners, *, n: int, m: int,
               levels: int, budget: int, cell_intersect: str = "triangle",
               clip=None, counts: torch.Tensor | None = None, l0_only=False,
               relax: int = 0, group="auto", pyr_min: torch.Tensor | None = None):
    """One budgeted march pass. Returns (new_state, new_results).

    CPU tensors run `march_pass_reference`; CUDA tensors launch the kernel
    (building it on first use) or raise. `corners` is the scene's (m, m, 4)
    corner-record plane. `counts`, an int32 (2, P) output, takes each ray's
    steps and exact cell tests in this pass (the kernel's counting
    instance; the timed path passes none). `l0_only` and `relax`: the tail
    modes (module docstring); a relaxed pass counts every step, and the
    exact walk's intersector calls as cell tests. `group`: the level-0
    tail's lanes a ray, "auto" or one of GROUPS (module docstring).
    `pyr_min`: the
    scene's min pyramid (`Scene.pyr_min_flat`), which the kernel's exact
    level-0 tail reads: a pass that may run that tail on the card raises
    without it."""
    check_tail(l0_only, relax, budget, group)
    p = rays[0].shape[0]
    flag = l0_only if isinstance(l0_only, torch.Tensor) else None
    dev = _build.device_of([*rays, *state, *results, pyr_flat, heights, corners]
                           + ([] if flag is None else [flag])
                           + ([] if pyr_min is None else [pyr_min]))
    if flag is not None and flag.numel() != 1:
        raise ValueError(f"l0_only: want a bool or a 0-dim flag, got shape {tuple(flag.shape)}")
    if pyr_min is not None:
        check_min_pyramid(pyr_min, m)
    if counts is not None:
        check_counts(counts, (2, p), dev)
    if dev.type == "cpu":
        work = None if counts is None else WorkCounter(pyr_flat.shape[0], n, dev, lanes=p)
        out = march_pass_reference(rays, state, results, pyr_flat, heights,
                                   n=n, m=m, levels=levels, budget=budget,
                                   cell_intersect=cell_intersect, clip=clip, counter=work,
                                   l0_only=l0_only, relax=relax, group=group,
                                   pyr_min=pyr_min)
        if work is not None:
            counts.copy_(torch.stack([work.lane_steps, work.lane_tests]))
        return out
    if dev.type != "cuda":
        raise ValueError(f"march_pass runs on cpu or cuda, not {dev}")
    _check_inputs(rays, state, results, pyr_flat, corners, n, m, levels, budget)
    mode = (MODE_MAXMIP if flag is None and not l0_only
            else MODE_RELAX if relax else MODE_L0)
    if mode == MODE_L0 and pyr_min is None:
        raise ValueError("the exact level-0 tail on the card reads the min pyramid: "
                         "pass pyr_min=scene.pyr_min_flat")
    lib = _build.library()
    outs = [torch.empty_like(x) for x in (*state, *results)]
    lo, hi = (0.0, float(n - 1)) if clip is None else clip
    with torch.cuda.device(dev):
        next_ray = torch.zeros(1, dtype=torch.int32, device=dev)
        flag_i = None if flag is None else flag.reshape(1).to(torch.int32)
        err = lib.hmrt_march_pass(
            *[x.data_ptr() for x in (*rays, *state, *results, *outs)],
            pyr_flat.data_ptr(), corners.data_ptr(),
            pyr_min.data_ptr() if mode == MODE_L0 else None, p, m, levels, budget,
            INTERSECTOR_IDS[cell_intersect], mode, relax, float(lo), float(hi),
            None if flag_i is None else flag_i.data_ptr(),
            1 if group == "auto" else group,
            march_pass.mode_launches.slots(dev).data_ptr(), next_ray.data_ptr(),
            None if counts is None else counts.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "march_pass")
    if p:  # an empty pass launches nothing
        march_pass.launches += 1
    return tuple(outs[:5]), tuple(outs[5:])


march_pass.launches = 0
#: the same launches by the march each one ran, counted on the card
march_pass.mode_launches = LaunchTally()
