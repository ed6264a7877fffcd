"""The plain version of the shade kernel and the port's shading functions,
held against the JAX package on the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmrt_tpu.api.scene import make_scene as jax_make_scene
from hmrt_tpu.io.heightmap import procedural_terrain
from hmrt_tpu.kernels.compact import shade_pass as jax_shade_pass
from hmrt_tpu.shading import shade as jsh
from hmrt_tpu_torch import make_scene
from hmrt_tpu_torch.kernels.shade_pass import shade_pass, shade_pass_reference
from hmrt_tpu_torch.shading import shade as tsh

torch.set_num_threads(2)  # the suite runs several workers at once

N = 128
P = 2048


@pytest.fixture(scope="module")
def terrain():
    return procedural_terrain(N, seed=3)


def _lanes(seed):
    """Random shade-pass inputs: ~70% hits in random cells of the map."""
    rng = np.random.default_rng(seed)
    hit = (rng.uniform(size=P) < 0.7).astype(np.int32)
    hx = rng.integers(0, N - 1, P).astype(np.int32)
    hy = rng.integers(0, N - 1, P).astype(np.int32)
    fx = rng.uniform(0, 1, P).astype(np.float32)
    fy = rng.uniform(0, 1, P).astype(np.float32)
    return hit, hx, hy, fx, fy


@pytest.mark.parametrize("textured", [False, True])
def test_shade_pass_reference_matches_jax_kernel(terrain, textured):
    """shade_pass_reference on the scene's records vs the TPU kernel
    (interpret mode) on a packed 128^2 scene, within 1e-6 (1/sqrt vs
    rsqrt)."""
    albedo = (np.random.default_rng(1).uniform(0.2, 0.9, (N, N, 3)).astype(np.float32)
              if textured else None)
    js = jax_make_scene(terrain, albedo=albedo)
    ts = make_scene(terrain, albedo=albedo, device="cpu")
    lanes = _lanes(2)
    want = jax_shade_pass(js.packed.shade, js.packed.albedo if textured else None,
                          *map(jnp.asarray, lanes), m5=js.packed.m5,
                          textured=textured, interpret=True)
    got = shade_pass_reference(*map(torch.from_numpy, lanes), ts.shade_rec,
                               ts.albedo_rec if textured else None)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    miss = lanes[0] == 0
    assert (got[2].numpy()[miss] == 1.0).all() and (got[3].numpy()[miss] == np.float32(0.55)).all()


def test_shade_pass_cpu_uses_plain_version(terrain):
    ts = make_scene(terrain, device="cpu")
    lanes = [torch.from_numpy(a) for a in _lanes(3)]
    before = shade_pass.launches
    for a, b in zip(shade_pass(*lanes, ts.shade_rec),
                    shade_pass_reference(*lanes, ts.shade_rec)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert shade_pass.launches == before


def _points(seed, n=N, p=P):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, n, p).astype(np.float32),
            rng.uniform(-1, n, p).astype(np.float32))


def test_gradient_normal_matches_jax(terrain):
    px, py = _points(4)
    want = jsh.gradient_normal(jnp.asarray(terrain.reshape(-1)), N,
                               jnp.asarray(px), jnp.asarray(py))
    got = tsh.gradient_normal(torch.from_numpy(terrain.reshape(-1)), N,
                              torch.from_numpy(px), torch.from_numpy(py))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def test_sample_height_matches_jax(terrain):
    """Bit for bit against the JAX function run op by op, and within 1e-6
    relative of it jitted (XLA may contract multiply-adds); the points
    reach a cell past every edge of the map."""
    px, py = _points(5)
    px[:4], py[:4] = (-3.5, N + 2.0, 0.25, N - 1.0), (0.5, -7.0, N + 0.5, N - 1.0)
    hf = terrain.reshape(-1)
    got = tsh.sample_height(torch.from_numpy(hf), N, torch.from_numpy(px),
                            torch.from_numpy(py)).numpy()
    args = (jnp.asarray(hf), N, jnp.asarray(px), jnp.asarray(py))
    np.testing.assert_array_equal(got, np.asarray(jsh.sample_height(*args)))
    jitted = jax.jit(jsh.sample_height, static_argnums=1)(*args)
    np.testing.assert_allclose(got, np.asarray(jitted), rtol=1e-6)


def test_sample_albedo_matches_jax():
    alb = np.random.default_rng(5).uniform(0, 1, (3, N * N)).astype(np.float32)
    px, py = _points(6)
    want = jsh.sample_albedo(jnp.asarray(alb), N, jnp.asarray(px), jnp.asarray(py))
    got = tsh.sample_albedo(torch.from_numpy(alb), N, torch.from_numpy(px),
                            torch.from_numpy(py))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def test_lighting_functions_match_jax():
    """Lambert, Phong, sky and fog within 1e-6 (pow, exp and sqrt may round
    an ulp apart across frameworks)."""
    rng = np.random.default_rng(8)
    v = [rng.normal(size=P).astype(np.float32) for _ in range(3)]
    nrm = np.sqrt(v[0] ** 2 + v[1] ** 2 + v[2] ** 2)
    nx, ny, nz = (c / nrm for c in v)
    light = np.array([0.4, 0.3, 0.85], np.float32) / np.float32(np.linalg.norm([0.4, 0.3, 0.85]))
    view = [rng.normal(size=P).astype(np.float32) for _ in range(3)]
    vn = np.sqrt(view[0] ** 2 + view[1] ** 2 + view[2] ** 2)
    view = [c / vn for c in view]
    t = rng.uniform(0, 3000, P).astype(np.float32)
    col = [rng.uniform(0, 1, P).astype(np.float32) for _ in range(3)]
    J, Tt = jnp.asarray, torch.from_numpy
    pairs = [
        (jsh.lambert(J(nx), J(ny), J(nz), *light),
         tsh.lambert(Tt(nx), Tt(ny), Tt(nz), *map(float, light))),
        (jsh.phong_specular(J(nx), J(ny), J(nz), *light, *map(J, view), 32.0),
         tsh.phong_specular(Tt(nx), Tt(ny), Tt(nz), *map(float, light),
                            *map(Tt, view), 32.0)),
    ]
    top, hor = np.float32([0.35, 0.55, 0.95]), np.float32([0.75, 0.85, 0.98])
    pairs += list(zip(jsh.sky_color(J(nz), J(top), J(hor)),
                      tsh.sky_color(Tt(nz), Tt(top), Tt(hor))))
    fog = np.float32([0.7, 0.78, 0.88])
    pairs += list(zip(jsh.apply_fog(*map(J, col), J(t), 0.0015, J(fog)),
                      tsh.apply_fog(*map(Tt, col), Tt(t), 0.0015, Tt(fog))))
    for w, g in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
