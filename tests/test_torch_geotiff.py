"""The port's TIFF reader (hmrt_tpu_torch/io/geotiff.py) against the JAX
package's on the same files: strips and tiles; none, deflate, LZW and
PackBits; predictors 1, 2 and 3; both byte orders; BigTIFF; and every
truncation raising a clean ValueError."""

import numpy as np
import pytest

from hmrt_tpu.io import geotiff as jtiff
from hmrt_tpu.io.heightmap import load_heightmap as jax_load_heightmap
from hmrt_tpu_torch.io import geotiff as ttiff
from hmrt_tpu_torch.io.heightmap import load_heightmap
from test_geotiff import _write_tiff

RNG = np.random.default_rng(0)
GRIDS = {
    "f32": RNG.uniform(0, 1000, (37, 53)).astype(np.float32),
    "i16": RNG.integers(-500, 4000, (23, 31), dtype=np.int16),
    "u16": RNG.integers(0, 65535, (11, 17), dtype=np.uint16),
    "u8": RNG.integers(0, 255, (19, 21), dtype=np.uint8),
}
CASES = [  # (grid, writer options)
    ("f32", {}), ("f32", {"comp": 8}), ("f32", {"comp": 32946}),
    ("f32", {"comp": 8, "tiled": True}), ("f32", {"tiled": True}),
    ("f32", {"comp": 8, "predictor": 3}), ("f32", {"comp": 8, "predictor": 3, "tiled": True}),
    ("i16", {"comp": 8, "predictor": 2}), ("i16", {"predictor": 2, "tiled": True}),
    ("u16", {"bo": ">"}), ("u16", {"bo": ">", "comp": 8, "predictor": 2}),
    ("u8", {}), ("f32", {"big": True}), ("f32", {"big": True, "tiled": True, "comp": 8}),
]


@pytest.mark.parametrize("grid,opts", CASES, ids=[f"{g}-{o}" for g, o in CASES])
def test_read_tiff_gray_equals_jax(tmp_path, grid, opts):
    p = str(tmp_path / "d.tif")
    _write_tiff(p, GRIDS[grid], **opts)
    got = ttiff.read_tiff_gray(p)
    assert got.dtype == jtiff.read_tiff_gray(p).dtype
    np.testing.assert_array_equal(got, jtiff.read_tiff_gray(p))
    np.testing.assert_array_equal(got, GRIDS[grid])
    np.testing.assert_array_equal(load_heightmap(p), jax_load_heightmap(p))


@pytest.mark.parametrize("compression", ["tiff_lzw", "tiff_deflate", "packbits"])
def test_pillow_written_tiffs(tmp_path, compression):
    """LZW and PackBits as a real encoder writes them."""
    PIL = pytest.importorskip("PIL.Image")
    for i, img in enumerate(GRIDS.values()):
        p = str(tmp_path / f"pil{i}.tif")
        PIL.fromarray(img).save(p, compression=compression)
        np.testing.assert_array_equal(ttiff.read_tiff_gray(p), jtiff.read_tiff_gray(p))
        np.testing.assert_array_equal(ttiff.read_tiff_gray(p), img)


def test_decoders_equal_jax():
    rng = np.random.default_rng(9)
    enc = bytes([2]) + b"abc" + bytes([253]) + b"x" + bytes([0]) + b"z" + bytes([128])
    assert ttiff._packbits_decode(enc) == jtiff._packbits_decode(enc) == b"abcxxxxz"
    for _ in range(20):
        junk = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
        assert ttiff._packbits_decode(junk) == jtiff._packbits_decode(junk)


def test_unsupported_and_truncated_raise(tmp_path):
    p = str(tmp_path / "px.tif")
    _write_tiff(p, GRIDS["f32"], predictor=4)
    with pytest.raises(ValueError, match="predictor"):
        ttiff.read_tiff_gray(p)
    q = tmp_path / "bad.tif"
    q.write_bytes(b"XX\x2a\x00")
    with pytest.raises(ValueError, match="not a TIFF"):
        ttiff.read_tiff_gray(str(q))


def test_tiff_truncation_fuzz(tmp_path):
    for opts in ({}, {"comp": 8, "tiled": True}, {"big": True}):
        p = str(tmp_path / "t.tif")
        _write_tiff(p, GRIDS["f32"], **opts)
        data = open(p, "rb").read()
        q = str(tmp_path / "cut.tif")
        for cut in list(range(0, len(data), 13)) + [len(data) - 1]:
            with open(q, "wb") as f:
                f.write(data[:cut])
            with pytest.raises(ValueError):
                ttiff.read_tiff_gray(q)
