"""The port's command lines (hmrt_tpu_torch/cli) with --cpu against the JAX
package's at the same small sizes: the render CLI's outputs (still, aux
buffers, tiled from an in-memory map and from a .r32 file, texture,
flythrough, --sharded) and the viewer's HTML and APNG."""

import functools
from datetime import timedelta

import numpy as np
import pytest
import torch

from hmrt_tpu.cli.render import main as jax_render_main
from hmrt_tpu.io.image import read_png as jax_read_png
from hmrt_tpu_torch.cli.render import main as render_main
from hmrt_tpu_torch.cli.view import main as view_main
from hmrt_tpu_torch.distrib import mesh as dm
from hmrt_tpu_torch.io.image import read_png, write_png

torch.set_num_threads(2)  # the suite runs several workers at once


def _both(tmp_path, args, name="r.png"):
    """Run both CLIs with `args` (the port's with --cpu); their output paths."""
    ours, theirs = str(tmp_path / ("t_" + name)), str(tmp_path / ("j_" + name))
    assert render_main([*args, "--cpu", "-o", ours]) == 0
    assert jax_render_main([*args, "-o", theirs]) == 0
    return ours, theirs


def _lsb(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def test_render_png_and_aux_equal_jax(tmp_path):
    ours, theirs = _both(tmp_path, ["--size", "64", "--width", "48", "--height", "32",
                                    "--shadows", "--fog", "--aux"])
    img = read_png(ours)
    assert img.shape == (32, 48, 3) and img.max() > 0
    assert _lsb(img, jax_read_png(theirs)) <= 1
    d_t, d_j = (np.load(p.rsplit(".", 1)[0] + "_depth.npy") for p in (ours, theirs))
    hit = np.isfinite(d_j)
    np.testing.assert_array_equal(np.isfinite(d_t), hit)
    np.testing.assert_allclose(d_t[hit], d_j[hit], rtol=1e-5, atol=1e-4)
    n_t, n_j = (read_png(p.rsplit(".", 1)[0] + "_normal.png") for p in (ours, theirs))
    assert _lsb(n_t, n_j) <= 1


def test_sharded_png_equals_the_plain_png(tmp_path, monkeypatch):
    """--sharded --cpu spawns one gloo rank; rank 0 writes the same PNG.
    The rank gets a 60 s process-group timeout and join limit."""
    monkeypatch.setattr(dm, "spawn", functools.partial(
        dm.spawn, timeout=timedelta(seconds=60), join_timeout=60))
    args = ["--size", "64", "--width", "48", "--height", "32", "--shadows", "--cpu"]
    plain, sharded = str(tmp_path / "p.png"), str(tmp_path / "s.png")
    assert render_main([*args, "-o", plain]) == 0
    assert render_main([*args, "--sharded", "-o", sharded]) == 0
    np.testing.assert_array_equal(read_png(sharded), read_png(plain))
    assert render_main([*args, "--sharded", "--tile", "32", "-o", sharded]) == 2


def test_tiled_equals_jax(tmp_path):
    ours, theirs = _both(tmp_path, ["--size", "80", "--width", "32", "--height", "24",
                                    "--tile", "48", "--shadows"])
    assert _lsb(read_png(ours), jax_read_png(theirs)) <= 1


def test_tiled_from_a_raw_file_equals_jax(tmp_path):
    from hmrt_tpu_torch.io.heightmap import procedural_terrain
    raw = tmp_path / "map.r32"
    procedural_terrain(97, seed=5).tofile(raw)
    ours, theirs = _both(tmp_path, [str(raw), "--width", "32", "--height", "24",
                                    "--tile", "48", "--tile-cache", "4"])
    assert _lsb(read_png(ours), jax_read_png(theirs)) <= 1


def test_albedo_texture_equals_jax(tmp_path):
    tex = np.random.default_rng(4).uniform(0.0, 1.0, (40, 40, 3)).astype(np.float32)
    texp = str(tmp_path / "tex.png")
    write_png(texp, tex)
    ours, theirs = _both(tmp_path, ["--size", "64", "--width", "32", "--height", "24",
                                    "--albedo", texp])
    assert _lsb(read_png(ours), jax_read_png(theirs)) <= 1


def test_flythrough_and_view(tmp_path):
    ours, theirs = _both(tmp_path, ["--size", "64", "--width", "32", "--height", "24",
                                    "--flythrough", "3"], name="fly.npy")
    stack = np.load(ours)
    assert stack.shape == (3, 24, 32, 3)
    np.testing.assert_allclose(stack, np.load(theirs), atol=5e-5, rtol=0)
    html = str(tmp_path / "fly.html")
    assert view_main([ours, "-o", html]) == 0
    assert open(html).read().count("'iVBOR") == 3   # three base64 PNG frames
    apng = str(tmp_path / "fly.apng")
    assert view_main([ours, "-o", apng]) == 0
    data = open(apng, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and b"acTL" in data and data.count(b"fcTL") == 3


def test_tiled_flythrough(tmp_path):
    out = str(tmp_path / "fly.npy")
    assert render_main(["--size", "80", "--width", "32", "--height", "24", "--tile", "48",
                        "--flythrough", "2", "--tile-cache", "4", "--cpu", "-o", out]) == 0
    stack = np.load(out)
    assert stack.shape == (2, 24, 32, 3) and np.isfinite(stack).all()


def test_without_cpu_it_needs_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        render_main(["--size", "64", "-o", str(tmp_path / "x.png")])
