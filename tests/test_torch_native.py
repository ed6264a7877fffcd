"""The port's host library (`hmrt_tpu_torch/io/native/`) against the numpy
specs of both packages, bit for bit: the fBm terrain, the PNG unfilter and
`read_png` through it, and the library's build."""

import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

import hmrt_tpu.io.heightmap as jax_heightmap
import hmrt_tpu.io.image as jax_image
import hmrt_tpu.io.native as jax_native
from hmrt_tpu_torch.io import image, native
from hmrt_tpu_torch.io.heightmap import procedural_terrain, procedural_terrain_reference

ROOT = Path(__file__).resolve().parents[1]


def jax_spec_terrain(monkeypatch, n, seed, ridged):
    """The JAX package's numpy path (its native evaluator switched off)."""
    with monkeypatch.context() as m:
        m.setattr(jax_native, "terrain_fbm", lambda *a, **k: None)
        return jax_heightmap.procedural_terrain(n, seed=seed, ridged=ridged)


# 17 caps the finer octaves' cells at n; 257 and 1000 have inexact linspace steps
@pytest.mark.parametrize("ridged", [True, False])
@pytest.mark.parametrize("n", [17, 64, 257, 1000])
def test_fbm_equals_both_numpy_specs(monkeypatch, n, ridged):
    got = procedural_terrain(n, seed=5, ridged=ridged)
    assert got.shape == (n, n) and got.dtype == np.float32
    np.testing.assert_array_equal(got, procedural_terrain_reference(n, seed=5, ridged=ridged))
    np.testing.assert_array_equal(got, jax_spec_terrain(monkeypatch, n, 5, ridged))


def test_fbm_rejects_malformed_lattices():
    g = np.zeros((5, 5), np.float32)
    with pytest.raises(ValueError, match="lattice"):
        native.terrain_fbm(16, [g], [3], [1.0], True)
    with pytest.raises(ValueError, match="2 grids"):
        native.terrain_fbm(16, [g, g], [4], [1.0], True)


def filtered_stream(orig: np.ndarray, bpp: int, types) -> bytes:
    """PNG scanlines of `orig` (h, stride) uint8, row y filtered with
    types[y % len(types)]."""
    h, stride = orig.shape
    raw = bytearray()
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ft = types[y % len(types)]
        cur = orig[y].astype(np.int32)
        line = np.zeros(stride, np.int32)
        for i in range(stride):
            a = cur[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            if ft == 0:
                line[i] = cur[i]
            elif ft == 1:
                line[i] = cur[i] - a
            elif ft == 2:
                line[i] = cur[i] - b
            elif ft == 3:
                line[i] = cur[i] - ((a + b) >> 1)
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[i] = cur[i] - pr
        raw.append(ft)
        raw.extend((line & 0xFF).astype(np.uint8).tobytes())
        prev = cur
    return bytes(raw)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_unfilter_equals_both_specs(bpp):
    rng = np.random.default_rng(bpp)
    h, stride = 15, 7 * bpp + 3
    orig = rng.integers(0, 256, (h, stride), dtype=np.uint8)
    raw = np.frombuffer(filtered_stream(orig, bpp, range(5)), np.uint8)
    got = native.png_unfilter(raw, h, stride, bpp)
    np.testing.assert_array_equal(got, orig)
    np.testing.assert_array_equal(got, image._unfilter(raw, h, stride, bpp))
    np.testing.assert_array_equal(got, jax_image._unfilter(raw, h, stride, bpp))


def test_unfilter_rejects_a_bad_filter_byte():
    raw = np.frombuffer(filtered_stream(np.zeros((3, 4), np.uint8), 1, (0, 1, 2)), np.uint8)
    bad = raw.copy()
    bad[2 * 5] = 5
    with pytest.raises(ValueError, match="bad PNG filter type 5"):
        native.png_unfilter(bad, 3, 4, 1)
    with pytest.raises(ValueError, match="bad PNG filter type"):
        image._unfilter(bad, 3, 4, 1)
    with pytest.raises(ValueError, match="rows of 1"):
        native.png_unfilter(raw[:-1], 3, 4, 1)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def test_read_png_16bit_filtered_equals_jax(tmp_path):
    """A 16-bit grey PNG whose rows use the Paeth, Average and Sub filters
    reads the same through both packages (the port through its library)."""
    rng = np.random.default_rng(7)
    h, w = 23, 31
    img = rng.integers(0, 65536, (h, w), dtype=np.uint16)
    rows = img.astype(">u2").view(np.uint8).reshape(h, 2 * w)
    path = tmp_path / "dem16.png"
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0))
                     + _chunk(b"IDAT", zlib.compress(filtered_stream(rows, 2, (4, 3, 1))))
                     + _chunk(b"IEND", b""))
    got = image.read_png(str(path))
    np.testing.assert_array_equal(got, jax_image.read_png(str(path)))
    np.testing.assert_array_equal(got.reshape(h, w), img)


def test_concurrent_builds_both_load(tmp_path):
    """Two processes building the library into one empty directory at once
    both load a whole library, and no temporary file is left behind."""
    code = ("import ctypes, sys; from pathlib import Path; "
            "from hmrt_tpu_torch.io import native; "
            "lib = ctypes.CDLL(str(native.build(build_dir=Path(sys.argv[1])))); "
            "print(lib.terrain_fbm is not None)")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert [o[0].strip() for o in outs] == ["True", "True"]
    assert [f.name for f in tmp_path.iterdir()] == [native.library_path(
        build_dir=tmp_path).name]


def test_library_name_follows_the_flags(tmp_path):
    base = native.library_path()
    assert base.parent == ROOT / "build" / "hmrt_tpu_torch_native"
    assert native.library_path(native.GXX_FLAGS + ["-DHMRT_OTHER"]) != base
    assert native.library_path(build_dir=tmp_path).name == base.name
    assert "-ffp-contract=off" in native.GXX_FLAGS


def test_failed_build_raises_with_the_compiler_output(tmp_path):
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.build(native.GXX_FLAGS + ["--no-such-flag"], build_dir=tmp_path)
    assert "no-such-flag" in str(err.value)
    assert list(tmp_path.iterdir()) == []
