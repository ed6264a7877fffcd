"""Animation timing on a mesh of ranks (B5 and frame-parallel B4;
BASELINE.json:10-11).

Counterpart of `hmrt_tpu/distrib/bench.py`. Every rank calls these
together; each rep starts from a barrier and its time is the slowest
rank's (bench/timing.py), so every rank returns the same row.
"""

from __future__ import annotations

from hmrt_tpu_torch.api.flythrough import frame_camera
from hmrt_tpu_torch.bench.timing import time_animation
from hmrt_tpu_torch.config import RenderConfig
from hmrt_tpu_torch.distrib.mesh import Mesh, render_frame_sharded
from hmrt_tpu_torch.core.renderer import render_frame
from hmrt_tpu_torch.types import Camera, Scene


def time_animation_sharded(scene: Scene, cams: Camera, config: RenderConfig,
                           n_frames: int, mesh: Mesh, reps: int = 3,
                           hit_frac: float | None = None) -> dict:
    """Band sharding: every frame rendered by `render_frame_sharded`, each
    rank its row band, the frame gathered on every rank."""
    def render(i):
        render_frame_sharded(scene, frame_camera(cams, i), config, mesh)

    return time_animation(scene, cams, config, n_frames, reps=reps, hit_frac=hit_frac,
                          render=render, mesh=mesh)


def time_flythrough_frames(scene: Scene, cams: Camera, config: RenderConfig,
                           n_frames: int, mesh: Mesh, reps: int = 3,
                           hit_frac: float | None = None) -> dict:
    """Frame parallelism: rank r renders frames [r*F/k, (r+1)*F/k) of the
    n_frames (F, a multiple of the k ranks) through `render_frame`, with no
    traffic per frame. As in the JAX module, the time is the rendering's:
    the stack is not gathered (`render_flythrough_sharded` gathers it)."""
    if n_frames % mesh.size:
        raise ValueError(f"frame count {n_frames} must divide evenly over {mesh.size} ranks")
    local = n_frames // mesh.size

    def render(i):
        if i // local == mesh.rank:
            render_frame(scene, frame_camera(cams, i), config)

    return time_animation(scene, cams, config, n_frames, reps=reps, hit_frac=hit_frac,
                          render=render, mesh=mesh)
