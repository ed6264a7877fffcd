"""Render configuration: the same frozen dataclass as the JAX package's
`hmrt_tpu/config.py`, field for field and default for default, so one
configuration drives both packages in the parity tests."""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration.

    Capability surface (BASELINE.json:7-11):
      B1: uniform DDA + Lambert        -> traversal="dda",   shading="lambert"
      B2: max-mip + depth/normal bufs  -> traversal="maxmip", aux_buffers=True
      B3: shadows + Phong + sky test   -> shadows=True, shading="phong"
      B4: albedo texture + fog         -> texture=True, fog=True
      B5: multi-device band sharding   -> distrib/mesh.py render_frame_sharded
    """

    # --- image ---
    width: int = 512
    height: int = 512

    # --- traversal ---
    traversal: Literal["dda", "maxmip"] = "maxmip"
    #: Exact surface model inside a cell.
    cell_intersect: Literal["triangle", "bilinear", "flat"] = "triangle"
    #: Hard cap on oracle march iterations (0 = auto, see steps_for).
    max_steps: int = 0
    #: World cell window [lo, hi] to march, or None for the full terrain.
    clip_box: tuple | None = None

    # --- shading ---
    shading: Literal["lambert", "phong"] = "lambert"
    shadows: bool = False
    fog: bool = False
    texture: bool = False
    #: Write depth + world-space-normal aux buffers (BASELINE.json:8).
    aux_buffers: bool = False

    # --- shading params ---
    ambient: float = 0.15
    specular: float = 0.5
    shininess: float = 32.0
    fog_density: float = 0.0015

    # --- performance knobs ---
    #: Screen-tile height of the TPU's fused tile kernel; a Mosaic knob
    #: the CUDA kernel does not read (kept so both configs match).
    tile_h: int = 8
    #: "oracle"  = plain torch wavefront (runs anywhere, is the spec)
    #: "pallas"  = fused tile render, one CUDA thread per pixel
    #: "compact" = budgeted march passes + ray sorting (CUDA kernels)
    #: "auto"    = on CUDA compact for maps >= 1024^2, else fused;
    #:             the oracle on the CPU
    backend: Literal["auto", "oracle", "pallas", "compact"] = "auto"
    #: the fused path returns (frame, counts): four int32 (H, W) planes of
    #: each pixel's primary steps, primary cell tests, shadow steps and
    #: shadow cell tests (the kernel's counting instance; the plain
    #: version's WorkCounter on the CPU). The JAX kernel's three planes
    #: count steps of its Mosaic schedule (coarse wavefront steps, column
    #: switches, inner steps), which the port does not have. The compact
    #: and oracle paths ignore the flag.
    debug_counters: bool = False

    def steps_for(self, n_cells: int) -> int:
        if self.max_steps:
            return self.max_steps
        if self.traversal == "dda":
            return 4 * n_cells
        # max-mip: grazing terrain-hugging rays march O(N) fine cells with
        # descend/ascend overhead, so the cap scales with N, not log N, or
        # long rays would be silently abandoned as misses.
        return 8 * n_cells + 256
