"""The exact cell test in f32 depends on the coordinate frame: one ray of a
2049^2 orbit frame hits in world coordinates and slips past a cell edge
once the frame is moved by the exact integer offset of its tile, in the
port and in the JAX reference evaluated op by op alike; in float64 it hits
in both frames. This is why the tiled renderer can differ from the resident
one on a few grazing pixels of large maps (ROADMAP.md section 3)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import hmrt_tpu_torch as T
from hmrt_tpu.api.scene import make_scene as jax_make_scene
from hmrt_tpu.io.heightmap import procedural_terrain
from hmrt_tpu.traversal.march import march_maxmip as jax_march_maxmip
from hmrt_tpu_torch.api.flythrough import frame_camera
from hmrt_tpu_torch.kernels.compact import empty_results, init_state, primary_rays
from hmrt_tpu_torch.kernels.march_pass import UNBUDGETED, march_pass_reference

torch.set_num_threads(2)  # the suite runs several workers at once

N = 2049
#: the tile of render_frame_tiled(tile=512) that holds the hit, as the
#: offset of its sub-scene (x0 - 1, y0 - 1) and its cell window
OFFSET, CLIP = (-1, 1023), (1.0, 513.0)
HIT_CELL = (440, 1161)


@functools.cache
def _case():
    """The heights, the tile's sub-scene heights (its off-map margin column
    extrapolated as the tiled renderer does) and the ray: pixel 16753 of
    orbit frame 4 at 192x108."""
    h = procedural_terrain(N, seed=3)
    rows = slice(OFFSET[1], OFFSET[1] + 515)
    sub = np.concatenate([2.0 * h[rows, :1] - h[rows, 1:2], h[rows, :514]], axis=1)
    cams = T.orbit_flythrough(N, float(h.max()), 8, device="cpu")
    rays = primary_rays(frame_camera(cams, 4), T.RenderConfig(width=192, height=108))
    return h, sub, tuple(r[16753:16754].clone() for r in rays)


def _local(rays):
    return (rays[0] - OFFSET[0], rays[1] - OFFSET[1]) + rays[2:]


def _port_march(heights, rays, clip, dtype):
    sc = T.make_scene(heights, device="cpu")
    rays = tuple(r.to(dtype) for r in rays)
    pyr, hts = sc.pyr_flat.to(dtype), sc.heights.to(dtype)
    st = init_state(rays, None, pyr[-1], n=sc.n, m=sc.m, levels=sc.levels, clip=clip)
    hit, t, hx, hy = march_pass_reference(rays, st, empty_results(1, "cpu"), pyr, hts, n=sc.n,
                                          m=sc.m, levels=sc.levels, budget=UNBUDGETED,
                                          clip=clip)[1]
    return bool(hit[0]), float(t[0]), (int(hx[0]), int(hy[0]))


def test_port_f32_hit_depends_on_the_frame_and_f64_hits_in_both():
    h, sub, rays = _case()
    g32 = _port_march(h, rays, None, torch.float32)
    l32 = _port_march(sub, _local(rays), CLIP, torch.float32)
    g64 = _port_march(h, rays, None, torch.float64)
    l64 = _port_march(sub, _local(rays), CLIP, torch.float64)
    assert g32[0] and g32[2] == HIT_CELL
    assert not l32[0]
    local_cell = (HIT_CELL[0] - OFFSET[0], HIT_CELL[1] - OFFSET[1])
    assert g64[0] and g64[2] == HIT_CELL and l64[0] and l64[2] == local_cell
    assert abs(g64[1] - g32[1]) <= 1e-4 * g64[1] and abs(l64[1] - g64[1]) <= 1e-9 * g64[1]


def test_jax_reference_op_by_op_does_the_same():
    """The JAX march, evaluated op by op (the port's order of operations,
    ROADMAP.md section 3), hits in world coordinates and misses in the
    tile's frame, as the port does."""
    h, sub, rays = _case()
    got = {}
    for name, heights, rr, clip in (("global", h, rays, None),
                                    ("local", sub, _local(rays), CLIP)):
        sc = jax_make_scene(heights, pack=False)
        with jax.disable_jit():
            r = jax_march_maxmip(*(jnp.asarray(x.numpy()) for x in rr), sc.pyr_flat,
                                 sc.heights.reshape(-1), n=sc.n, m=sc.m, levels=sc.levels,
                                 max_steps=8 * (sc.n - 1) + 256, clip=clip)
        got[name] = bool(np.asarray(r.hit)[0])
    assert got == {"global": True, "local": False}
