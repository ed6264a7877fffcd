"""The work of one frame, counted by the march kernel, and its H100 bound.

Counterpart of `hmrt_tpu/bench/floor.py`. `count_frame` renders one
compact frame (`render_frame_compact`: pass 0, the sorted rounds, the
shade pass, the shadow rounds from the hit cells) with `march_pass`'s
counting instance, which writes each ray's steps and exact cell tests per
launch; on a CPU scene the plain version counts them with `WorkCounter`.
Under the max-mip march each ray's steps do not depend on the schedule (a
per-ray budget composes), so the totals are a property of the scene, the
camera and the exact algorithm; a forced level-0 tail (`l0_tail`) changes
them, and so does its lane group: one lane a ray passes under whole blocks
of the min pyramid, 32 lanes a ray step cell by cell (kernels/march_pass.py).

The bound is the least time the card could take for that march: the
larger of the bytes it must move over the memory rate and its operations
over the f32 rate. The JAX module's floors are built from TPU VPU rates
and Mosaic lane-steps, a different quantity; none of that carries over.
"""

from __future__ import annotations

import dataclasses

import torch

from hmrt_tpu_torch.config import RenderConfig
from hmrt_tpu_torch.types import Camera, Scene

# NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3, 67 TFLOP/s f32 outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations per unit of work, counted from the CUDA sources (float and
# integer arithmetic, compares and selects alike, all at the f32 rate):
OPS_PER_STEP = 50    # one max-mip step of march_common.cuh without the cell test
OPS_PER_TEST = 50    # the exact triangle test of a level-0 cell
OPS_PER_SHADE = 40   # shade_lane of shade_common.cuh on a hit
OPS_PER_ALBEDO = 40  # its three bilinear albedo samples on a textured hit
OPS_PER_PIXEL = 150  # render_tile.cu outside the marches: raygen, box, shade, colour
#: march_pass moves per live ray 15 planes in (rays, state, results) and 9
#: out; a dead lane reads no ray plane, so 9 in (state, results) and 9 out
MARCH_PLANE_BYTES = 4 * (15 + 9)
MARCH_DEAD_BYTES = 4 * (9 + 9)


def march_bytes(p: int, live: int) -> int:
    """The bytes one march_pass launch over `p` lanes, `live` of them alive,
    must move."""
    return live * MARCH_PLANE_BYTES + (p - live) * MARCH_DEAD_BYTES


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(bound in ms, what bounds it) for the given bytes and operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


@dataclasses.dataclass
class FrameCounts:
    """What the march kernel did in one frame, per launch."""

    counts: list          # per march_pass launch, int32 (2, P): steps, cell tests per ray
    n_primary: int        # the first n_primary launches march primary rays
    hit: torch.Tensor     # bool[P], the primary hits in launch order

    def totals(self, row: int) -> list[int]:
        """Per launch, the sum of `row` (0: steps, 1: cell tests)."""
        return [int(c[row].sum(dtype=torch.int64)) for c in self.counts]

    def live(self) -> list[int]:
        """Per launch, the lanes alive when it started: those that took a
        step (a live ray takes at least one, a dead lane none)."""
        return [int(torch.count_nonzero(c[0])) for c in self.counts]

    def launch_bound(self, k: int) -> tuple[float, str]:
        """Launch k's bound: its lanes' planes (`march_bytes`), and its steps
        and cell tests' operations."""
        c = self.counts[k]
        return bound(march_bytes(c.shape[1], self.live()[k]),
                     self.totals(0)[k] * OPS_PER_STEP + self.totals(1)[k] * OPS_PER_TEST)

    def bound(self) -> tuple[float, str]:
        """The march's bound on the frame: every launch moves its lanes'
        planes, and every step and cell test costs its operations."""
        p = self.hit.shape[0]
        return bound(sum(march_bytes(p, live) for live in self.live()),
                     sum(self.totals(0)) * OPS_PER_STEP + sum(self.totals(1)) * OPS_PER_TEST)


def count_frame(scene: Scene, camera: Camera, config: RenderConfig,
                l0_tail: bool | str = "auto", relax: int = 0) -> FrameCounts:
    """One compact frame of `config` from `camera` (`render_frame_compact`
    with `l0_tail` and `relax`), marched with the counting instance of
    `march_pass` (the plain `WorkCounter` on a CPU scene). A forced
    level-0 tail changes a ray's steps (it descends without steps, steps
    cell by cell above the terrain and passes under whole blocks below
    it), so the totals equal the schedule-free max-mip march's only where
    no tail is forced."""
    from hmrt_tpu_torch.kernels.compact import render_frame_compact
    counts = {"primary": [], "shadow": []}
    frame = render_frame_compact(scene, camera, config, counts=counts, l0_tail=l0_tail,
                                 relax=relax)
    return FrameCounts(counts=counts["primary"] + counts["shadow"],
                       n_primary=len(counts["primary"]), hit=frame.hit.reshape(-1))


def _lane_steps(fc: FrameCounts):
    steps, tests = fc.totals(0), fc.totals(1)
    k = fc.n_primary
    return sum(steps), {
        "lane_steps_primary": sum(steps[:k]),
        "lane_steps_shadow": sum(steps[k:]),
        "lane_steps_per_pass_primary": steps[:k],
        "lane_steps_per_pass_shadow": steps[k:],
        "cell_tests_per_frame": sum(tests),
        "march_launches_per_frame": len(fc.counts),
    }


def count_lane_steps(scene: Scene, camera: Camera, config: RenderConfig):
    """Total march steps of one frame, primary and shadow rays, counted per
    ray (`count_frame`). Returns (total_steps, detail dict)."""
    return _lane_steps(count_frame(scene, camera, config))


def floor_metrics(scene: Scene, camera: Camera, config: RenderConfig,
                  measured_ms: float | None = None, l0_tail: bool | str = "auto") -> dict:
    """The frame's march work (`count_lane_steps`) and its H100 bound for a
    bench row. `camera` may be a batched Camera (a leading frame axis, as
    an animation renders it): the counts and the bound are then the means
    over its frames. `measured_ms` is the row's ms/frame: the row then says
    how many times the march's bound the whole frame took. `l0_tail` as
    in `count_frame`."""
    from hmrt_tpu_torch.api.flythrough import frame_camera
    cams = ([frame_camera(camera, i) for i in range(camera.eye.shape[0])]
            if camera.eye.dim() == 2 else [camera])
    rows, bounds = [], []
    for cam in cams:
        fc = count_frame(scene, cam, config, l0_tail=l0_tail)
        steps, detail = _lane_steps(fc)
        rows.append({"lane_steps_per_frame": steps, **detail})
        bounds.append(fc.bound())

    def mean(vals):
        if isinstance(vals[0], list):
            return [mean(list(v)) for v in zip(*vals)]
        return vals[0] if len(vals) == 1 else sum(vals) / len(vals)

    out = {k: mean([r[k] for r in rows]) for k in rows[0]}
    bound_ms = mean([b[0] for b in bounds])
    out.update({
        "floor_frames": len(cams),
        "march_bound_ms": bound_ms,
        "march_bound_by": ", ".join(sorted({b[1] for b in bounds})),
        "bound_model": (f"H100 SXM {HBM_BYTES_PER_S / 1e12:.2f} TB/s, "
                        f"{F32_OPS_PER_S / 1e12:.0f} TFLOP/s f32; {OPS_PER_STEP} ops per "
                        f"step, {OPS_PER_TEST} per cell test, {MARCH_PLANE_BYTES} B of "
                        f"planes per live lane and launch, {MARCH_DEAD_BYTES} per dead one"),
    })
    if measured_ms is not None and bound_ms > 0:
        out["x_march_bound"] = measured_ms / bound_ms
    return out
