"""The per-cell shade records that the shade kernel reads (api/scene.py
shade_records), held against the JAX package's packed shade and albedo
bricks, and the same records on every way a Scene is made."""

import ctypes
import re
from datetime import timedelta

import numpy as np
import pytest
import torch

from hmrt_tpu.api.scene import make_scene as jax_make_scene
from hmrt_tpu.kernels.packing import BRICK
from hmrt_tpu_torch import make_scene, procedural_terrain
from hmrt_tpu_torch.api.scene import scene_from_arrays, shade_records
from hmrt_tpu_torch.bench.configs import bench_albedo
from hmrt_tpu_torch.config import RenderConfig
from hmrt_tpu_torch.distrib.dryrun import render_sharded_jobs, scene_digest
from hmrt_tpu_torch.distrib.mesh import make_mesh, replicate_scene, spawn
from hmrt_tpu_torch.kernels import _build
from hmrt_tpu_torch.kernels.shade_pass import (check_shade_records, shade_pass,
                                               shade_pass_reference)

torch.set_num_threads(2)  # the suite runs several workers at once


def _albedo(n, seed=1):
    return np.random.default_rng(seed).uniform(0.1, 0.9, (n, n, 3)).astype(np.float32)


def _cells(bricks, n):
    """JAX bricks (m5^2, ch, 8, 128) -> per-cell (n-1, n-1, ch) records."""
    a = np.asarray(bricks)
    m5, ch = int(round(np.sqrt(a.shape[0]))), a.shape[1]
    m = m5 * BRICK
    a = a.reshape(m5, m5, ch, BRICK, BRICK).transpose(0, 3, 1, 4, 2).reshape(m, m, ch)
    return a[:n - 1, :n - 1]


@pytest.mark.parametrize("n", [66, 129, 200])
def test_records_equal_jax_packed_bricks(n):
    """Cell for cell, exactly: the port's shade_rec and albedo_rec are the
    JAX package's packed shade and albedo bricks without the bricking."""
    terr = procedural_terrain(n, seed=3)
    alb = _albedo(n)
    packed = jax_make_scene(terr, albedo=alb, pack=True).packed
    sc = make_scene(terr, albedo=alb, device="cpu")
    assert sc.shade_rec.shape == (n - 1, n - 1, 8) and sc.albedo_rec.shape == (n - 1, n - 1, 12)
    np.testing.assert_array_equal(sc.shade_rec.numpy(), _cells(packed.shade, n))
    np.testing.assert_array_equal(sc.albedo_rec.numpy(), _cells(packed.albedo, n))


def test_untextured_scene_has_no_albedo_records():
    sc = make_scene(procedural_terrain(33, seed=3), device="cpu")
    assert sc.albedo_rec is None and sc.shade_rec.is_contiguous()
    check_shade_records(sc.shade_rec, None)


@pytest.mark.parametrize("textured", [False, True])
def test_scene_from_arrays_carries_make_scenes_records(textured):
    n = 65
    terr = procedural_terrain(n, seed=4)
    sc = make_scene(terr, albedo=_albedo(n) if textured else None, device="cpu")
    light = {k: getattr(sc.light, k).numpy() for k in
             ("sun_dir", "sun_color", "sky_top", "sky_horizon", "fog_color")}
    got = scene_from_arrays(sc.heights.numpy(), sc.pyr_flat.numpy(),
                            None if sc.albedo is None else sc.albedo.numpy(), light,
                            n=sc.n, m=sc.m, levels=sc.levels, device="cpu")
    assert torch.equal(got.shade_rec, sc.shade_rec)
    assert (got.albedo_rec is None) == (not textured)
    if textured:
        assert torch.equal(got.albedo_rec, sc.albedo_rec)


def test_replicate_scene_on_one_rank_rebuilds_the_records():
    """A one-rank gloo group: the replicated scene's records, packed from
    the broadcast planes, equal make_scene's bit for bit."""
    n = 40
    sc = make_scene(procedural_terrain(n, seed=5), albedo=_albedo(n), device="cpu")
    with make_mesh("cpu", "gloo") as mesh:
        rep = replicate_scene(sc, mesh)
    assert torch.equal(rep.shade_rec, sc.shade_rec) and torch.equal(rep.albedo_rec, sc.albedo_rec)
    assert rep.shade_rec.data_ptr() != sc.shade_rec.data_ptr()


def test_replicate_scene_on_two_gloo_ranks_carries_the_records():
    """Two spawned ranks: rank 0 builds a textured scene and replicates it;
    each rank's digest of every plane, the records included, equals this
    process's make_scene."""
    terr = procedural_terrain(48, seed=3)
    cfg = RenderConfig(width=16, height=8, shading="phong", texture=True)
    cam = ((24.0, -12.0, float(terr.max()) + 6.0), (24.0, 24.0, float(terr.mean())), 60.0)
    out, = spawn(render_sharded_jobs, 2, args=([dict(source=terr, config=cfg, camera=cam,
                                                      keep=False)],),
                 backend="gloo", devices=["cpu"] * 2, timeout=timedelta(seconds=60),
                 join_timeout=60, threads=1)
    want = scene_digest(make_scene(terr, albedo=bench_albedo(terr), device="cpu")).numpy()
    np.testing.assert_array_equal(out["scene_digests"], np.broadcast_to(want, (2, want.size)))
    assert out["frame"]["hit_diff"] == 0


def test_shade_records_of_planes():
    """shade_records on hand-made planes: each slot is the right corner."""
    n = 5
    gx = torch.arange(n * n, dtype=torch.float32).reshape(n, n)
    gy = -gx
    alb = torch.arange(3 * n * n, dtype=torch.float32).reshape(3, n * n) + 1000
    s, a = shade_records(gx, gy, alb)
    cy, cx = 2, 1
    corners = [(cy, cx), (cy, cx + 1), (cy + 1, cx), (cy + 1, cx + 1)]
    assert s[cy, cx].tolist() == [gx[c].item() for c in corners] + [gy[c].item() for c in corners]
    a3 = alb.reshape(3, n, n)
    assert a[cy, cx].tolist() == [a3[k][c].item() for k in range(3) for c in corners]


@pytest.mark.parametrize("bad", ["shape", "dtype", "strided", "misaligned", "albedo_shape",
                                 "albedo_misaligned"])
def test_check_shade_records_raises(bad):
    """The validator refuses what the kernel cannot read as float4 records."""
    c = 16
    good_s, good_a = torch.zeros((c, c, 8)), torch.zeros((c, c, 12))
    cases = {
        "shape": (torch.zeros((c, c, 4)), None),
        "dtype": (good_s.double(), None),
        "strided": (torch.zeros((c, c, 16))[..., :8], None),
        "misaligned": (torch.zeros(c * c * 8 + 1)[1:].view(c, c, 8), None),
        "albedo_shape": (good_s, torch.zeros((c + 1, c + 1, 12))),
        "albedo_misaligned": (good_s, torch.zeros(c * c * 12 + 1)[1:].view(c, c, 12)),
    }
    with pytest.raises(ValueError, match="rec"):
        check_shade_records(*cases[bad])
    check_shade_records(good_s, good_a)


def test_reference_clamps_cells_and_edges():
    """Hit cells on the last row and column and outside the grid read the
    clamped cell, as the kernel does; misses get the constants."""
    n = 20
    sc = make_scene(procedural_terrain(n, seed=6), albedo=_albedo(n), device="cpu")
    c = n - 1
    hx = torch.tensor([c - 1, c, -3, 0, 500, c - 1], dtype=torch.int32)
    hy = torch.tensor([c - 1, 0, 4, c, -7, 2], dtype=torch.int32)
    hit = torch.tensor([1, 1, 1, 1, 1, 0], dtype=torch.int32)
    fx = torch.tensor([0.25, 0.5, 0.75, 1.0, 0.0, 0.5])
    fy = torch.tensor([0.5, 0.125, 0.0, 1.0, 0.5, 0.5])
    got = shade_pass_reference(hit, hx, hy, fx, fy, sc.shade_rec, sc.albedo_rec)
    ccx, ccy = hx.clamp(0, c - 1), hy.clamp(0, c - 1)
    want = shade_pass_reference(hit, ccx, ccy, fx, fy, sc.shade_rec, sc.albedo_rec)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert [float(x[5]) for x in got] == [0.0, 0.0, 1.0, np.float32(0.55), np.float32(0.55),
                                          np.float32(0.55)]
    # on the CPU the wrapper is the plain version and launches nothing
    before = shade_pass.launches
    for g, w in zip(shade_pass(hit, hx, hy, fx, fy, sc.shade_rec, sc.albedo_rec), got):
        assert torch.equal(g, w)
    assert shade_pass.launches == before


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_c_signatures_match_the_sources(name):
    """The ctypes argument list of each kernel entry point matches its
    extern "C" prototype in csrc/ (pointers, ints and floats in order): a
    mismatch would only show as a refused call on the card."""
    src = "\n".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
    assert m, name
    kinds = []
    for arg in m.group(1).split(","):
        arg = arg.strip()
        kinds.append(ctypes.c_void_p if "*" in arg else
                     ctypes.c_float if arg.startswith("float") else ctypes.c_int)
    assert kinds == _build.SIGNATURES[name]
