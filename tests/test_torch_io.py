"""The port's image codec and heightmap loaders (hmrt_tpu_torch/io) against
the JAX package's on the same files: every reader returns the same array,
every writer the same bytes, and a corrupt or truncated file raises the
same clean ValueError."""

import struct
import sys
import zlib

import numpy as np
import pytest

from hmrt_tpu.io import heightmap as jhm
from hmrt_tpu.io import image as jim
from hmrt_tpu_torch.io import heightmap as thm
from hmrt_tpu_torch.io import image as tim
from test_io import _write_palette_png

CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(tag, body):
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def _filter_row(ftype, cur, prev, bpp):
    """Forward PNG filter of one scanline (int arrays) -> filtered bytes."""
    a = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
    if ftype == 0:
        pred = np.zeros_like(cur)
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = prev
    elif ftype == 3:
        pred = (a + prev) >> 1
    else:
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
    return ((cur - pred) & 0xFF).astype(np.uint8)


def _write_filtered_png(path, img, depth, color_type, seed):
    """PNG of `img` (H, W, C) with every row under a random filter 0-4."""
    h, w, ch = img.shape
    bpp = max(ch * depth // 8, 1)
    rows = (img.astype(">u2") if depth == 16 else img.astype(np.uint8)).reshape(h, -1)
    rows = rows.view(np.uint8).reshape(h, -1).astype(np.int64)
    rng = np.random.default_rng(seed)
    prev = np.zeros(rows.shape[1], np.int64)
    raw = b""
    for y in range(h):
        ftype = int(rng.integers(0, 5))
        raw += bytes([ftype]) + _filter_row(ftype, rows[y], prev, bpp).tobytes()
        prev = rows[y]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("color_type", [0, 2, 4, 6])
def test_read_png_every_color_type_and_filter(tmp_path, color_type, depth):
    rng = np.random.default_rng(color_type * 17 + depth)
    img = rng.integers(0, 1 << depth, (9, 13, CHANNELS[color_type]))
    p = str(tmp_path / "f.png")
    _write_filtered_png(p, img, depth, color_type, seed=depth)
    got = tim.read_png(p)
    np.testing.assert_array_equal(got, jim.read_png(p))
    np.testing.assert_array_equal(got, img)
    assert got.dtype == (np.uint16 if depth == 16 else np.uint8)
    np.testing.assert_array_equal(tim.read_png_gray(p), jim.read_png_gray(p))


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
@pytest.mark.parametrize("trns", [None, [7, 128]])
def test_read_png_palette(tmp_path, depth, trns):
    rng = np.random.default_rng(depth)
    ncol = 1 << depth
    pal = rng.integers(0, 256, (ncol, 3), dtype=np.uint8)
    idx = rng.integers(0, ncol, (5, 11), dtype=np.uint8)
    p = str(tmp_path / "pal.png")
    _write_palette_png(p, idx, pal, depth, trns=trns)
    got = tim.read_png(p)
    np.testing.assert_array_equal(got, jim.read_png(p))
    assert got.shape == (5, 11, 3 if trns is None else 4)


def test_writers_write_the_jax_bytes(tmp_path):
    rng = np.random.default_rng(3)
    rgb = rng.random((7, 10, 3)).astype(np.float32)
    gray16 = rng.integers(0, 65536, (6, 5), dtype=np.uint16)
    frames = rng.integers(0, 256, (3, 6, 9, 3), dtype=np.uint8)
    for name, write, jwrite, arg, kw in (
            ("a.png", tim.write_png, jim.write_png, rgb, {}),
            ("g.png", tim.write_png, jim.write_png, rgb[..., 0], {}),
            ("h.png", tim.write_png16, jim.write_png16, gray16, {}),
            ("p.ppm", tim.write_ppm, jim.write_ppm, rgb, {}),
            ("f.apng", tim.write_apng, jim.write_apng, frames, {"fps": 10})):
        write(str(tmp_path / ("t" + name)), arg, **kw)
        jwrite(str(tmp_path / ("j" + name)), arg, **kw)
        assert (tmp_path / ("t" + name)).read_bytes() == (tmp_path / ("j" + name)).read_bytes()
    assert tim.encode_png(rgb) == jim.encode_png(rgb)
    np.testing.assert_array_equal(tim.read_png(str(tmp_path / "th.png"))[..., 0], gray16)


def test_apng_round_trip(tmp_path):
    """Each APNG frame, cut out as a PNG of its own, reads back."""
    frames = np.random.default_rng(5).integers(0, 256, (3, 6, 9, 3), dtype=np.uint8)
    p = tmp_path / "anim.apng"
    tim.write_apng(str(p), frames, fps=10)
    data = p.read_bytes()
    pos, chunks = 8, []
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        chunks.append((data[pos + 4:pos + 8], data[pos + 8:pos + 8 + ln]))
        pos += 12 + ln
    assert struct.unpack(">II", dict(chunks)[b"acTL"]) == (3, 0)
    datas = ([b for t, b in chunks if t == b"IDAT"]
             + [b[4:] for t, b in chunks if t == b"fdAT"])
    for i, d in enumerate(datas):
        q = tmp_path / f"f{i}.png"
        q.write_bytes(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", dict(chunks)[b"IHDR"])
                      + _chunk(b"IDAT", d) + _chunk(b"IEND", b""))
        np.testing.assert_array_equal(tim.read_png(str(q)), frames[i])


def _heightmap_files(d):
    """Write one small file of each loader's format under d; their names."""
    rng = np.random.default_rng(7)
    g8 = rng.integers(0, 256, (12, 15), dtype=np.uint8)
    g16 = rng.integers(0, 65536, (9, 8), dtype=np.uint16)
    f = rng.uniform(-50, 900, (10, 10)).astype(np.float32)
    np.save(d / "h.npy", f)
    np.savez(d / "h.npz", grid=f)
    f.tofile(d / "h.r32")
    f.tofile(d / "h.raw")
    (d / "a.pgm").write_text("P2\n# comment\n3 2\n255\n0 128 255\n64 32 16\n")
    (d / "b.pgm").write_bytes(b"P5\n15 12\n255\n" + g8.tobytes())
    (d / "c.pgm").write_bytes(b"P5 8 9 65535\n" + g16.astype(">u2").tobytes())
    tim.write_png(str(d / "h.png"), g8)
    tim.write_png16(str(d / "h16.png"), g16)
    (d / "d.asc").write_text("ncols 3\nnrows 2\nxllcorner 0\nyllcorner 0\ncellsize 30\n"
                             "NODATA_value -9999\n1 2 3\n4 -9999 6\n")
    return ["h.npy", "h.npz", "h.r32", "h.raw", "a.pgm", "b.pgm", "c.pgm", "h.png",
            "h16.png", "d.asc"]


def test_load_heightmap_every_format(tmp_path):
    for name in _heightmap_files(tmp_path):
        p = str(tmp_path / name)
        for z in (None, 3.0):
            got = thm.load_heightmap(p, z_scale=z)
            want = jhm.load_heightmap(p, z_scale=z)
            assert got.dtype == np.float32, name
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_load_heightmap_point_cloud(tmp_path):
    pts = np.random.default_rng(1).uniform(0, 50, (500, 3)).astype(np.float32)
    p = str(tmp_path / "cloud.xyz")
    np.savetxt(p, pts)
    got = thm.load_heightmap(p, z_scale=10.0)
    assert got.shape == (1024, 1024)
    np.testing.assert_array_equal(got, jhm.load_heightmap(p, z_scale=10.0))


def test_pillow_route_without_pillow_raises(tmp_path, monkeypatch):
    p = tmp_path / "h.jpg"
    p.write_bytes(b"\xff\xd8\xff")
    monkeypatch.setitem(sys.modules, "PIL", None)   # as on a machine without Pillow
    with pytest.raises(ValueError, match="Pillow"):
        thm.load_heightmap(str(p))
    with pytest.raises(ValueError, match="Pillow"):
        thm.load_texture(str(p))


def test_pillow_route(tmp_path):
    PIL = pytest.importorskip("PIL.Image")
    img = np.random.default_rng(6).integers(0, 255, (20, 20, 3), dtype=np.uint8)
    p = str(tmp_path / "t.bmp")
    PIL.fromarray(img).save(p)
    np.testing.assert_array_equal(thm.load_heightmap(p), jhm.load_heightmap(p))
    np.testing.assert_array_equal(thm.load_texture(p, 33), jhm.load_texture(p, 33))


@pytest.mark.parametrize("n", [None, 8, 33])
def test_load_texture(tmp_path, n):
    rng = np.random.default_rng(4)
    for name, img in (("rgb.png", rng.random((16, 16, 3))),
                      ("ga.png", rng.random((16, 16, 2))),
                      ("g.png", rng.random((16, 16)))):
        p = str(tmp_path / name)
        tim.write_png(p, img.astype(np.float32))
        got = thm.load_texture(p, n)
        assert got.shape == ((16, 16, 3) if n is None else (n, n, 3))
        np.testing.assert_array_equal(got, jhm.load_texture(p, n), err_msg=name)


def _same_outcome(read_t, read_j, path):
    """Both readers raise ValueError, or both return the same array."""
    try:
        want = read_j(path)
    except ValueError:
        with pytest.raises(ValueError):
            read_t(path)
        return False
    np.testing.assert_array_equal(read_t(path), want)
    return True


def test_png_truncation_fuzz(tmp_path):
    p = tmp_path / "t.png"
    tim.write_png(str(p), np.random.default_rng(0).random((17, 23, 3)))
    data = p.read_bytes()
    q = tmp_path / "cut.png"
    decoded = 0
    for cut in list(range(0, len(data), 7)) + [len(data) - 1]:
        q.write_bytes(data[:cut])
        decoded += _same_outcome(tim.read_png, jim.read_png, str(q))
    assert 0 < decoded < 10   # only cuts past the pixel data decode


def test_png_corruption_raises(tmp_path):
    p = tmp_path / "t.png"
    tim.write_png(str(p), np.zeros((4, 5, 3), np.uint8))
    data = bytearray(p.read_bytes())
    data[41] ^= 0xFF   # inside the zlib stream of IDAT
    (tmp_path / "bad.png").write_bytes(bytes(data))
    with pytest.raises(ValueError):
        tim.read_png(str(tmp_path / "bad.png"))
    (tmp_path / "notpng.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        tim.read_png(str(tmp_path / "notpng.png"))


def test_asc_truncation_fuzz(tmp_path):
    h = (np.random.default_rng(0).random((19, 19)) * 1000).astype(np.float32)
    p = tmp_path / "t.asc"
    with open(p, "w") as f:
        f.write("ncols 19\nnrows 19\nxllcorner 0\nyllcorner 0\ncellsize 1\n"
                "NODATA_value -9999\n")
        for row in h:
            f.write(" ".join(f"{v:.2f}" for v in row) + "\n")
    data = p.read_bytes()
    np.testing.assert_array_equal(thm.load_heightmap(str(p)), jhm.load_heightmap(str(p)))
    q = tmp_path / "cut.asc"
    for cut in range(0, len(data) - 8, 11):
        q.write_bytes(data[:cut])
        with pytest.raises(ValueError):
            thm.load_heightmap(str(q))
