"""The colour pass's plain version (kernels/shade_color.py) held against the
JAX package's shading functions composed as its oracle composes them
(hmrt_tpu/core/renderer.py::shade_hits), and the wrapper's checks.

JAX is imported only where it is used: tests/test_torch_shade_color_cuda.py
imports `lanes` and FLAGS from here on a machine without it."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import hmrt_tpu_torch as T
from hmrt_tpu_torch.bench.configs import bench_albedo
from hmrt_tpu_torch.config import RenderConfig
from hmrt_tpu_torch.kernels import compact
from hmrt_tpu_torch.kernels import shade_color as sc_mod
from hmrt_tpu_torch.kernels.shade_color import shade_color, shade_color_reference
from hmrt_tpu_torch.types import Light

torch.set_num_threads(2)  # the suite runs several workers at once

P = 4096
LIGHT = Light.create(device="cpu")


def lanes(seed, p=P, textured=True, shadows=True):
    """Colour-pass inputs: ~70% hits; unit directions over the whole
    sphere (dz < 0 and > 0); unit normals facing up; t up to 3,000 with one
    lane in 16 at 1e5 (fog's factor underflows to 0); ~40% of the lanes in
    shadow; untextured, the albedo is the shade pass's 0.55 everywhere.
    Returns the argument tuple after which `light, config` follow."""
    rng = np.random.default_rng(seed)
    hit = (rng.uniform(size=p) < 0.7).astype(np.int32)
    t = rng.uniform(0.0, 3000.0, p).astype(np.float32)
    t[::16] = 1e5
    d = rng.normal(size=(p, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    n = rng.normal(size=(p, 3))
    n[:, 2] = np.abs(n[:, 2]) + 0.2
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    alb = rng.uniform(0.2, 0.9, (p, 3)) if textured else np.full((p, 3), 0.55)
    occ = (rng.uniform(size=p) < 0.4).astype(np.int32)

    def planes(a):
        return tuple(torch.from_numpy(np.ascontiguousarray(a[:, k], np.float32))
                     for k in range(3))
    return (torch.from_numpy(hit), torch.from_numpy(t), planes(d), planes(n),
            planes(alb), torch.from_numpy(occ) if shadows else None)


def jax_color(args, light: Light, cfg: RenderConfig):
    """The oracle's colour maths (shade_hits after its normals, shadow
    march and albedo) in the JAX package's functions."""
    import jax.numpy as jnp

    from hmrt_tpu.shading import shade as jsh
    hit_i, t, dirs, normal, albedo, shadow_hit = args
    j = {k: jnp.asarray(getattr(light, k).numpy()) for k in
         ("sun_dir", "sun_color", "sky_top", "sky_horizon", "fog_color")}
    hit = jnp.asarray(hit_i.numpy()) != 0
    dx, dy, dz = (jnp.asarray(x.numpy()) for x in dirs)
    nx, ny, nz = (jnp.asarray(x.numpy()) for x in normal)
    lx, ly, lz = j["sun_dir"][0], j["sun_dir"][1], j["sun_dir"][2]
    ts = jnp.where(hit, jnp.asarray(t.numpy()), 0.0)
    diff = jsh.lambert(nx, ny, nz, lx, ly, lz)
    if shadow_hit is not None:
        occ = jnp.asarray(shadow_hit.numpy()) != 0
        diff = jnp.where(occ, 0.0, diff)
    ar, ag, ab = (jnp.asarray(x.numpy()) for x in albedo)
    sr, sg, sb = j["sun_color"][0], j["sun_color"][1], j["sun_color"][2]
    r = ar * (cfg.ambient + diff * sr)
    g = ag * (cfg.ambient + diff * sg)
    b = ab * (cfg.ambient + diff * sb)
    if cfg.shading == "phong":
        spec = jsh.phong_specular(nx, ny, nz, lx, ly, lz, -dx, -dy, -dz, cfg.shininess)
        if shadow_hit is not None:
            spec = jnp.where(occ, 0.0, spec)
        r = r + cfg.specular * spec * sr
        g = g + cfg.specular * spec * sg
        b = b + cfg.specular * spec * sb
    if cfg.fog:
        r, g, b = jsh.apply_fog(r, g, b, ts, cfg.fog_density, j["fog_color"])
    skyr, skyg, skyb = jsh.sky_color(dz, j["sky_top"], j["sky_horizon"])
    color = jnp.stack([jnp.where(hit, r, skyr), jnp.where(hit, g, skyg),
                       jnp.where(hit, b, skyb)], axis=-1)
    depth = jnp.where(hit, jnp.asarray(t.numpy()), jnp.inf)
    normal = jnp.stack([jnp.where(hit, c, 0.0) for c in (nx, ny, nz)], axis=-1)
    return np.asarray(jnp.clip(color, 0.0, 1.0)), np.asarray(depth), np.asarray(normal)


#: (shading, shadows, fog, texture, aux_buffers)
FLAGS = list(itertools.product(("phong", "lambert"), (False, True), (False, True),
                               (False, True), (False, True)))


@pytest.mark.parametrize("shading, shadows, fog, texture, aux", FLAGS)
def test_reference_matches_jax(shading, shadows, fog, texture, aux):
    """Colour within the repo's bar of 5e-5, depth and normals equal, and
    None without aux_buffers."""
    cfg = RenderConfig(shading=shading, shadows=shadows, fog=fog, texture=texture,
                       aux_buffers=aux)
    args = lanes(7, textured=texture, shadows=shadows)
    color, depth, normal = shade_color_reference(*args, LIGHT, cfg)
    want_color, want_depth, want_normal = jax_color(args, LIGHT, cfg)
    assert color.shape == (P, 3) and color.dtype == torch.float32
    np.testing.assert_allclose(color.numpy(), want_color, rtol=0, atol=5e-5)
    assert float(color.min()) >= 0.0 and float(color.max()) <= 1.0
    if aux:
        np.testing.assert_array_equal(depth.numpy(), want_depth)
        np.testing.assert_array_equal(normal.numpy(), want_normal)
    else:
        assert depth is None and normal is None


def test_the_lanes_reach_every_branch():
    """The inputs hold misses looking up and down, hits facing away from
    the sun, hits whose reflection points away from the eye (rdv = 0) and
    hits whose fog factor is 0."""
    hit_i, t, (dx, dy, dz), (nx, ny, nz), _, _ = lanes(7)
    hit = hit_i != 0
    lx, ly, lz = LIGHT.sun_dir
    ndl = nx * lx + ny * ly + nz * lz
    rdv = ((2.0 * ndl * nx - lx) * -dx + (2.0 * ndl * ny - ly) * -dy
           + (2.0 * ndl * nz - lz) * -dz)
    assert bool((~hit & (dz < 0)).any()) and bool((~hit & (dz > 0)).any())
    assert bool((hit & (ndl <= 0)).any()) and bool((hit & (ndl > 0) & (rdv <= 0)).any())
    assert bool((hit & (ndl > 0) & (rdv > 0)).any())
    assert float(torch.exp(-t.max() * RenderConfig().fog_density)) == 0.0


@pytest.mark.parametrize("texture", [False, True])
def test_shade_frame_hands_the_colour_step_the_shade_pass_planes(monkeypatch, texture):
    """A compact frame on the CPU gives the colour step the shade pass's
    own normal and albedo planes (0.55 everywhere untextured) and the
    shadow march's hits, and its Frame holds the colour step's colour and
    the primary march's hit flag."""
    terr = T.procedural_terrain(65, seed=3)
    scene = T.make_scene(terr, albedo=bench_albedo(terr) if texture else None, device="cpu")
    cam = T.Camera.create(eye=(32.0, -20.0, 40.0), target=(32.0, 32.0, 5.0), device="cpu")
    cfg = RenderConfig(width=24, height=16, shading="phong", shadows=True, texture=texture,
                       backend="compact")
    shaded, seen, shade_pass = [], [], compact.shade_pass

    def shade(*args):
        shaded.append(shade_pass(*args))
        return shaded[-1]

    def colour_step(*args):
        seen.append((args, shade_color(*args)))
        return seen[-1][1]

    monkeypatch.setattr(compact, "shade_pass", shade)
    monkeypatch.setattr(compact, "shade_color", colour_step)
    fr = compact.render_frame_compact(scene, cam, cfg)
    assert len(shaded) == 1 and len(seen) == 1
    (hit_i, _, _, normal, albedo, shadow_hit, light, config), (rgb, _, _) = seen[0]
    assert all(a is b for a, b in zip(normal + albedo, shaded[0]))
    if not texture:
        assert all(bool((a == 0.55).all()) for a in albedo)
    assert shadow_hit is not None and light is scene.light and config is cfg
    assert fr.hit.dtype == torch.bool and torch.equal(fr.hit, (hit_i != 0).reshape(16, 24))
    assert bool(fr.hit.any()) and not bool(fr.hit.all())
    assert torch.equal(fr.color, rgb.reshape(16, 24, 3))


def test_cpu_tensors_run_the_plain_version(monkeypatch):
    """On the CPU the wrapper runs the plain version (the same tensors'
    values) and never builds the kernels."""
    def no_build():
        raise AssertionError("the CPU path built the kernels")
    monkeypatch.setattr(sc_mod._build, "library", no_build)
    for cfg in (RenderConfig(shading="phong", shadows=True, aux_buffers=True),
                RenderConfig(fog=True, texture=True)):
        args = lanes(5, textured=cfg.texture, shadows=cfg.shadows)
        got = shade_color(*args, LIGHT, cfg)
        want = shade_color_reference(*args, LIGHT, cfg)
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a, b)


def _fault(name, args, light):
    """`args` and `light` with one fault of the kind `name`."""
    hit, t, dirs, normal, albedo, occ = args
    if name == "dtype":
        t = t.double()
    elif name == "hit_dtype":
        hit = hit != 0
    elif name == "occ_dtype":
        occ = occ.float()
    elif name == "shape":
        dirs = (dirs[0], dirs[1], dirs[2][:-1])
    elif name == "two_dims":
        hit = hit.reshape(64, -1)
    elif name == "non_contiguous":
        normal = (torch.stack([normal[0], normal[0]], 1).reshape(-1)[::2],) + normal[1:]
    elif name == "albedo_planes":
        albedo = albedo[:2]
    elif name == "mixed_devices":
        albedo = (albedo[0].to("meta"),) + albedo[1:]
    elif name == "meta_device":
        hit, t, occ = hit.to("meta"), t.to("meta"), occ.to("meta")
        dirs, normal, albedo = ([x.to("meta") for x in v] for v in (dirs, normal, albedo))
        light = Light(*(getattr(light, f.name).to("meta") for f in dataclasses.fields(light)))
    elif name == "light_shape":
        light = dataclasses.replace(light, sun_color=torch.ones(4))
    elif name == "light_dtype":
        light = dataclasses.replace(light, sky_top=light.sky_top.double())
    return (hit, t, dirs, normal, albedo, occ), light


@pytest.mark.parametrize("fault", ["dtype", "hit_dtype", "occ_dtype", "shape", "two_dims",
                                   "non_contiguous", "albedo_planes", "mixed_devices",
                                   "meta_device", "light_shape", "light_dtype"])
def test_wrapper_raises_on_planes_the_kernel_cannot_read(fault):
    args, light = _fault(fault, lanes(9), LIGHT)
    with pytest.raises(ValueError):
        shade_color(*args, light, RenderConfig(shading="phong", shadows=True, texture=True))
