"""The cone-ratio field (core/cone.py) of the port: bit-equal to the JAX
package's on random grids, the conservative-bound invariant, and hit
decisions of the cone-jump march equal to brute-force DDA (the cases of
tests/test_cone.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hmrt_tpu_torch as T
from conftest import random_rays
from hmrt_tpu.core.cone import build_cone as jax_build_cone
from hmrt_tpu.core.cone import cone_safe_cells as jax_cone_safe_cells
from hmrt_tpu_torch.core.cone import CONE_RADIUS, build_cone, cone_safe_cells
from hmrt_tpu_torch.traversal.march import WorkCounter, march_dda, march_maxmip

torch.set_num_threads(2)  # the suite runs several workers at once


@pytest.mark.parametrize("n,radius", [(48, 8), (33, 16), (64, CONE_RADIUS)])
def test_build_cone_bit_equal_to_jax(n, radius):
    h = np.random.default_rng(n).uniform(0, 30, (n, n)).astype(np.float32)
    want = np.asarray(jax_build_cone(jnp.asarray(h), radius))
    got = build_cone(torch.from_numpy(h), radius).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_cone_safe_cells_bit_equal_to_jax():
    """On random inputs, with zero cones and zero slopes (the division's
    two fallbacks) among them."""
    rng = np.random.default_rng(5)
    p = 4096
    z = rng.uniform(-5, 20, p).astype(np.float32)
    apex = rng.uniform(0, 10, p).astype(np.float32)
    cone = rng.uniform(0, 3, p).astype(np.float32)
    g = rng.uniform(-1, 1, p).astype(np.float32)
    cone[:200], g[:200] = 0.0, 0.0
    args = (z, apex, cone, g)
    want = np.asarray(jax_cone_safe_cells(*map(jnp.asarray, args), 64))
    got = cone_safe_cells(*map(torch.from_numpy, args), 64).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() == 0 and got.max() == 62


@pytest.mark.parametrize("seed,radius", [(0, 8), (1, 16)])
def test_cone_bound_invariant(seed, radius):
    """Every sample within the radius sits at or below the cone surface."""
    rng = np.random.default_rng(seed)
    n = 48
    h = rng.uniform(0, 30, (n, n)).astype(np.float32)
    c = build_cone(torch.from_numpy(h), radius).numpy()
    assert (c >= 0).all()
    for i, j in rng.integers(0, n, (40, 2)):
        y0, y1 = max(0, i - radius), min(n, i + radius + 1)
        x0, x1 = max(0, j - radius), min(n, j + radius + 1)
        for u in range(y0, y1):
            for v in range(x0, x1):
                d = max(abs(u - i), abs(v - j))
                if d:
                    assert h[u, v] <= h[i, j] + c[i, j] * d + 1e-4 * d, (i, j, u, v)


def test_cone_flat_terrain_is_zero():
    c = build_cone(torch.full((32, 32), 5.0), 8)
    torch.testing.assert_close(c, torch.zeros(32, 32), atol=1e-6, rtol=0)


def test_cone_single_spike():
    h = torch.zeros(33, 33)
    h[16, 16] = 10.0
    c = build_cone(h, 16)
    for d in (1, 2, 5):  # neighbours at Chebyshev distance d need ratio 10/d
        assert float(c[16, 16 - d]) == pytest.approx(10.0 / d, rel=1e-5)
    assert float(c[16, 16]) == 0.0  # the spike dominates everything around it


def test_cone_safe_cells_monotone():
    z = torch.tensor([10.0, 10.0, 10.0, 0.5])
    apex = torch.zeros(4)
    cone = torch.tensor([0.5, 2.0, 0.0, 0.5])
    g = torch.tensor([0.0, 0.0, 0.1, 0.0])
    k = cone_safe_cells(z, apex, cone, g, 64)
    assert k[0] >= 2            # clear air over a mild cone
    assert k[1] < k[0]          # a wider cone jumps less far
    assert k[2] == 62           # a zero cone and a climbing ray: the radius cap
    assert k[3] < 2             # hugging: no clearance


def _run_cone(n, seed, n_rays=512, kind="mixed", radius=32, intersect="triangle",
              grazing=False):
    """The cone-jump march, brute-force DDA and the plain max-mip march of
    the same rays, each with its WorkCounter."""
    terr = T.procedural_terrain(n, seed=seed)
    sc = T.make_scene(terr, device="cpu")
    if grazing:  # near-horizontal rays from just above the terrain: the B3 tail
        rng = np.random.default_rng(seed)
        hmax = float(terr.max())
        o = np.stack([rng.uniform(0, n - 1, n_rays), np.full(n_rays, -0.5),
                      rng.uniform(0.3 * hmax, 1.1 * hmax, n_rays)], -1).astype(np.float32)
        d = np.stack([rng.uniform(-0.3, 0.3, n_rays), np.ones(n_rays),
                      rng.uniform(-0.05, 0.02, n_rays)], -1).astype(np.float32)
        d = d / np.linalg.norm(d, axis=1, keepdims=True)
    else:
        o, d = random_rays(n_rays, n, seed=seed, kind=kind)
    args = [torch.from_numpy(np.ascontiguousarray(a[:, i], np.float32))
            for a in (o, d) for i in range(3)]
    hf = sc.heights.reshape(-1)
    cone = build_cone(sc.heights, radius).reshape(-1)
    kw = dict(n=n, m=sc.m, levels=sc.levels, max_steps=16 * n, cell_intersect=intersect)
    work = [WorkCounter(sc.pyr_flat.shape[0], n, "cpu") for _ in range(2)]
    acc = march_maxmip(*args, sc.pyr_flat, hf, cone_flat=cone, cone_radius=radius,
                       any_hit=True, counter=work[0], **kw)
    ref = march_dda(*args, hf, n=n, max_steps=8 * n, cell_intersect=intersect)
    plain = march_maxmip(*args, sc.pyr_flat, hf, counter=work[1], **kw)
    return acc, ref, plain, [int(w.steps) for w in work]


@pytest.mark.parametrize("n,seed,kind,grazing", [
    (64, 0, "mixed", False), (64, 1, "mixed", False), (256, 2, "mixed", False),
    (64, 5, "axis", False), (128, 3, None, True), (128, 4, None, True)])
def test_cone_march_equals_bruteforce(n, seed, kind, grazing):
    acc, ref, _, _ = _run_cone(n, seed, kind=kind or "mixed", grazing=grazing)
    np.testing.assert_array_equal(acc.hit.numpy(), ref.hit.numpy())
    m = acc.hit.numpy()
    np.testing.assert_array_equal(acc.cx.numpy()[m], ref.cx.numpy()[m])
    np.testing.assert_array_equal(acc.cy.numpy()[m], ref.cy.numpy()[m])
    np.testing.assert_allclose(acc.t.numpy()[m], ref.t.numpy()[m], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("intersect", ["bilinear", "flat"])
def test_cone_march_other_surface_models(intersect):
    acc, ref, _, _ = _run_cone(64, 7, intersect=intersect)
    np.testing.assert_array_equal(acc.hit.numpy(), ref.hit.numpy())
    m = acc.hit.numpy()
    np.testing.assert_allclose(acc.t.numpy()[m], ref.t.numpy()[m], rtol=1e-5, atol=1e-4)


def test_cone_never_increases_work():
    """The JAX package's measured negative result: on fBm terrain the jump
    fires on ~0% of level-0 steps. It must at least never ADD work: it
    replaces a one-cell step by a jump of k >= 2 cells only where safe."""
    acc, _, plain, (w_acc, w_plain) = _run_cone(256, 3, n_rays=512, grazing=True, radius=64)
    assert w_acc <= w_plain, (w_acc, w_plain)
    np.testing.assert_array_equal(acc.hit.numpy(), plain.hit.numpy())


def test_cone_jumps_on_climbing_rays_match_jax():
    """Rays climbing from just above the terrain (shadow-ray-like): here the
    jump fires, and the cone march equals the JAX package's cone march (hit
    and hit cells exact, t to 1e-5, the same lane-steps) and brute-force
    DDA's hits, with fewer steps than the march without the cone."""
    from hmrt_tpu.api.scene import make_scene as jax_make_scene
    from hmrt_tpu.traversal.march import march_maxmip as jax_march_maxmip
    n, p, radius = 128, 1024, 32
    terr = T.procedural_terrain(n, seed=4)
    sc = T.make_scene(terr, device="cpu")
    rng = np.random.default_rng(0)
    x, y = rng.uniform(1, n - 2, p), rng.uniform(1, n - 2, p)
    z = terr[np.floor(y).astype(int), np.floor(x).astype(int)] + rng.uniform(0.05, 3.0, p)
    d = np.stack([rng.uniform(-0.6, 0.6, p), rng.uniform(-0.6, 0.6, p),
                  rng.uniform(0.05, 0.9, p)], -1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    planes = [np.ascontiguousarray(a, np.float32) for a in (x, y, z, d[:, 0], d[:, 1], d[:, 2])]
    args = [torch.from_numpy(a) for a in planes]
    hf = sc.heights.reshape(-1)
    kw = dict(n=n, m=sc.m, levels=sc.levels, max_steps=16 * n)
    work = [WorkCounter(sc.pyr_flat.shape[0], n, "cpu") for _ in range(2)]
    acc = march_maxmip(*args, sc.pyr_flat, hf, cone_flat=build_cone(sc.heights, radius)
                       .reshape(-1), cone_radius=radius, counter=work[0], **kw)
    march_maxmip(*args, sc.pyr_flat, hf, counter=work[1], **kw)
    assert int(work[0].steps) < int(work[1].steps)
    ref = march_dda(*args, hf, n=n, max_steps=8 * n)
    np.testing.assert_array_equal(acc.hit.numpy(), ref.hit.numpy())
    js = jax_make_scene(terr, pack=False)
    want = jax_march_maxmip(*map(jnp.asarray, planes), js.pyr_flat, js.heights.reshape(-1),
                            cone_flat=jax_build_cone(js.heights, radius).reshape(-1),
                            cone_radius=radius, **kw)
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(acc.hit.numpy(), hit)
    np.testing.assert_array_equal(acc.cx.numpy(), np.asarray(want.cx))
    np.testing.assert_array_equal(acc.cy.numpy(), np.asarray(want.cy))
    np.testing.assert_allclose(acc.t.numpy()[hit], np.asarray(want.t)[hit], rtol=1e-5, atol=0)
    assert int(work[0].steps) == int(want.work)
    assert hit.any()
