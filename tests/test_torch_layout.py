"""The per-cell corner records the CUDA march reads level 0 from, held
against the heights, the pyramid and the JAX package's scene; the record
and count checks of the kernel wrappers; and the per-ray counts of the
wrappers' plain versions against the plain WorkCounter."""

import dataclasses

import numpy as np
import pytest
import torch

import hmrt_tpu_torch as T
from conftest import random_rays
from hmrt_tpu.api.scene import make_scene as jax_make_scene
from hmrt_tpu.io.heightmap import procedural_terrain
from hmrt_tpu_torch.api.scene import scene_from_arrays
from hmrt_tpu_torch.core.pyramid import NEG_INF, corner_records, next_pow2
from hmrt_tpu_torch.kernels.compact import init_state
from hmrt_tpu_torch.kernels.march_pass import (UNBUDGETED, check_records, march_pass,
                                               march_pass_reference)
from hmrt_tpu_torch.kernels.raycast import fused_planes, fused_reference_planes
from hmrt_tpu_torch.traversal.march import WorkCounter

torch.set_num_threads(2)  # the suite runs several workers at once


@pytest.mark.parametrize("n", [2, 3, 100, 129])
def test_corner_records_hold_the_corners_and_level0(n):
    """Record [cy, cx] is (h[cy, cx], h[cy, cx+1], h[cy+1, cx], h[cy+1, cx+1])
    bit for bit; its max is pyramid level 0 bit for bit; padded cells
    (n - 1 < m: n = 100 pads 99 cells to 128) are NEG_INF in every slot."""
    h = np.random.default_rng(n).uniform(-5, 20, (n, n)).astype(np.float32)
    m = next_pow2(n - 1)
    rec = corner_records(torch.from_numpy(h), m)
    assert rec.shape == (m, m, 4) and rec.dtype == torch.float32 and rec.is_contiguous()
    r = rec.numpy()
    c = n - 1
    np.testing.assert_array_equal(r[:c, :c, 0], h[:-1, :-1])
    np.testing.assert_array_equal(r[:c, :c, 1], h[:-1, 1:])
    np.testing.assert_array_equal(r[:c, :c, 2], h[1:, :-1])
    np.testing.assert_array_equal(r[:c, :c, 3], h[1:, 1:])
    pad = np.ones((m, m), bool)
    pad[:c, :c] = False
    assert (r[pad] == np.float32(NEG_INF)).all()
    # the kernel's cell max, in its order, against level 0 of the pyramid
    cmax = np.maximum(np.maximum(r[..., 0], r[..., 1]), np.maximum(r[..., 2], r[..., 3]))
    level0 = T.build_pyramid_flat(torch.from_numpy(h)).numpy()[:m * m].reshape(m, m)
    np.testing.assert_array_equal(cmax.view(np.int32), level0.view(np.int32))


@pytest.mark.parametrize("n", [65, 100])
def test_corner_records_equal_from_jax_scene_arrays(n):
    """scene_from_arrays derives the plane from the JAX scene's heights; it
    equals the port's own make_scene's, and its max equals level 0 of the
    JAX package's pyramid bit for bit. The plane lives on the scene's
    device."""
    terr = procedural_terrain(n, seed=3)
    js = jax_make_scene(terr, pack=False)
    light = {f.name: np.asarray(getattr(js.light, f.name))
             for f in dataclasses.fields(js.light)}
    ts = scene_from_arrays(np.asarray(js.heights), np.asarray(js.pyr_flat), None, light,
                           n=js.n, m=js.m, levels=js.levels, device="cpu")
    own = T.make_scene(terr, device="cpu")
    for sc in (ts, own):
        assert sc.corners.device == sc.device == torch.device("cpu")
    np.testing.assert_array_equal(ts.corners.numpy(), own.corners.numpy())
    r = ts.corners.numpy()
    cmax = np.maximum(np.maximum(r[..., 0], r[..., 1]), np.maximum(r[..., 2], r[..., 3]))
    level0 = np.asarray(js.pyr_flat)[:js.m * js.m].reshape(js.m, js.m)
    np.testing.assert_array_equal(cmax.view(np.int32), level0.view(np.int32))


def _bad_planes(m):
    good = torch.zeros((m, m, 4))
    misaligned = torch.zeros(m * m * 4 + 1)[1:].view(m, m, 4)
    return {"shape": torch.zeros((m, m, 3)), "side": torch.zeros((m + 1, m + 1, 4)),
            "dtype": good.double(), "strided": torch.zeros((m, m, 8))[..., :4],
            "misaligned": misaligned}


@pytest.mark.parametrize("bad", ["shape", "side", "dtype", "strided", "misaligned"])
def test_record_check_raises(bad):
    m = 16
    check_records(torch.zeros((m, m, 4)), m)
    with pytest.raises(ValueError, match="corners"):
        check_records(_bad_planes(m)[bad], m)


@pytest.fixture(scope="module")
def scene():
    return T.make_scene(procedural_terrain(65, seed=3), device="cpu")


def _rays(n, p, seed):
    o, d = random_rays(p, n, seed=seed)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                 for a in (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]))


def _empty_results(p):
    return (torch.zeros(p, dtype=torch.int32), torch.full((p,), 3.0e38),
            torch.zeros(p, dtype=torch.int32), torch.zeros(p, dtype=torch.int32))


@pytest.mark.parametrize("budget", [12, UNBUDGETED])
def test_march_pass_counts_equal_work_counter(scene, budget):
    """march_pass's counts= plane (per-ray steps and cell tests) sums to the
    plain WorkCounter's totals, and the planes are those of the pass
    without counts."""
    rays = _rays(scene.n, 300, seed=11)
    st = init_state(rays, None, scene.pyr_flat[-1], n=scene.n, m=scene.m,
                    levels=scene.levels)
    kw = dict(n=scene.n, m=scene.m, levels=scene.levels, budget=budget)
    counts = torch.full((2, 300), -1, dtype=torch.int32)
    got = march_pass(rays, st, _empty_results(300), scene.pyr_flat, scene.heights,
                     scene.corners, counts=counts, **kw)
    work = WorkCounter(scene.pyr_flat.shape[0], scene.n, "cpu")
    want = march_pass_reference(rays, st, _empty_results(300), scene.pyr_flat,
                                scene.heights, counter=work, **kw)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b)
    assert int(counts[0].sum()) == int(work.steps) > 0
    assert int(counts[1].sum()) == int(work.tests) > 0
    assert int(counts[0].max()) <= budget and int(counts.min()) >= 0
    with pytest.raises(ValueError, match="counts"):
        march_pass(rays, st, _empty_results(300), scene.pyr_flat, scene.heights,
                   scene.corners, counts=torch.zeros((2, 299), dtype=torch.int32), **kw)


@pytest.mark.parametrize("shadows", [False, True])
def test_fused_counts_equal_work_counter(scene, shadows):
    """fused_planes' counts= plane (4, H, W): primary steps and tests, then
    shadow steps and tests, per pixel; each pair sums to the plain
    version's counter of that march."""
    cam = T.Camera.create(eye=(32.0, -20.0, 45.0), target=(32.0, 32.0, 5.0), device="cpu")
    cfg = T.RenderConfig(width=13, height=7, shading="phong", shadows=shadows)
    counts = torch.full((4, 7, 13), -1, dtype=torch.int32)
    got = fused_planes(scene, cam, cfg, cells=True, counts=counts)
    prim = WorkCounter(scene.pyr_flat.shape[0], scene.n, "cpu")
    shad = WorkCounter(scene.pyr_flat.shape[0], scene.n, "cpu")
    want = fused_reference_planes(scene, cam, cfg, counter=prim, shadow_counter=shad)
    assert torch.equal(got[3].reshape(-1), want[3])
    assert [int(counts[k].sum()) for k in range(4)] == [
        int(prim.steps), int(prim.tests), int(shad.steps), int(shad.tests)]
    assert int(prim.steps) > 0 and (int(shad.steps) > 0) == shadows
    # the pixels that missed march no shadow ray
    assert int(counts[2][~got[3]].sum()) == 0
