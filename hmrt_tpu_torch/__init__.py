"""hmrt_tpu_torch -- the heightmap raytracer in PyTorch, with CUDA kernels.

The port of `hmrt_tpu` (JAX/Pallas) to PyTorch and hand-written CUDA for
NVIDIA Hopper. It imports torch and never jax; the JAX package is the
reference it is tested against. Entry points:

    procedural_terrain -> make_scene -> Camera -> render_frame -> Frame

plus `load_heightmap` (DEM files), `flythrough`/`orbit_flythrough`
(batched cameras), `render_frame_tiled` (out-of-core maps),
`save_state`/`load_state`, the multi-card renders of `distrib/mesh.py` and
the command lines `python -m hmrt_tpu_torch.cli.{render,serve,view,bench}`.
"""

from hmrt_tpu_torch.api.flythrough import flythrough, orbit_flythrough
from hmrt_tpu_torch.api.scene import make_scene
from hmrt_tpu_torch.api.tiled import render_frame_tiled
from hmrt_tpu_torch.config import RenderConfig
from hmrt_tpu_torch.core.pyramid import build_pyramid_flat
from hmrt_tpu_torch.core.renderer import render_frame
from hmrt_tpu_torch.io.heightmap import load_heightmap, procedural_terrain
from hmrt_tpu_torch.io.state import load_state, save_state
from hmrt_tpu_torch.types import Camera, Frame, Light, Scene

__version__ = "0.1.0"

__all__ = [
    "Camera", "Frame", "Light", "RenderConfig", "Scene",
    "build_pyramid_flat", "flythrough", "load_heightmap", "load_state", "make_scene",
    "orbit_flythrough", "procedural_terrain", "render_frame", "render_frame_tiled", "save_state",
]
