"""Heightmap loading, procedural terrain and height normalisation (numpy).

A copy of `hmrt_tpu/io/heightmap.py`, with its loaders:

  - .npy / .npz        (numpy)
  - .pgm (P2/P5, 8/16-bit)
  - .png (8/16-bit grayscale or RGB -> luminance), io/image.py's codec
  - .raw / .r32        (flat float32, square)
  - .tif / .tiff       (io/geotiff.py)
  - .asc               (ESRI ASCII grid DEM)
  - .xyz / .csv / .txt (point clouds, gridded by io/pointcloud.py)
  - anything else through Pillow where it is installed, else a ValueError

and its procedural terrain. `procedural_terrain` draws the octave lattices
here and sums the octaves in the port's host library (`io/native/`, C++
built with g++ on first use); `procedural_terrain_reference` is the numpy
spec it equals bit for bit, as the JAX package's native evaluator does, so
both packages build the very same terrain from one seed.
"""

from __future__ import annotations

import os
import re

import numpy as np

from hmrt_tpu_torch.io import image as _image
from hmrt_tpu_torch.io.native import terrain_fbm


def normalize_heights(h: np.ndarray, z_scale: float = None) -> np.ndarray:
    """Normalize raw sample values to world z units: by default z spans
    ~12% of the horizontal extent (terrain-like relief)."""
    h = np.asarray(h, np.float32)
    lo, hi = float(h.min()), float(h.max())
    if hi - lo < 1e-12:
        return np.zeros_like(h)
    if z_scale is None:
        z_scale = 0.12 * (max(h.shape) - 1)
    return (h - lo) / (hi - lo) * np.float32(z_scale)


def load_heightmap(path: str, z_scale: float = None) -> np.ndarray:
    """Load a heightmap file -> float32 (H, W) array in world z units."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        h = np.load(path)
    elif ext == ".npz":
        with np.load(path) as z:
            h = z[list(z.files)[0]]
    elif ext == ".pgm":
        h = _load_pgm(path)
    elif ext == ".png":
        h = _image.read_png_gray(path)
    elif ext in (".raw", ".r32"):
        flat = np.fromfile(path, dtype=np.float32)
        n = int(round(len(flat) ** 0.5))
        if n * n != len(flat):
            raise ValueError(f"{path}: raw f32 file is not square ({len(flat)} floats)")
        h = flat.reshape(n, n)
    elif ext in (".tif", ".tiff"):
        from hmrt_tpu_torch.io.geotiff import read_tiff_gray
        h = read_tiff_gray(path)
    elif ext == ".asc":
        h = _load_esri_ascii(path)
    elif ext in (".xyz", ".csv", ".txt"):
        # scattered point cloud -> gridded heightmap (io/pointcloud.py)
        from hmrt_tpu_torch.io.pointcloud import grid_points, load_points
        h = grid_points(load_points(path), n=1024)
    else:
        h = _load_via_pillow(path, ext)
    return normalize_heights(h, z_scale)


def _load_via_pillow(path: str, ext: str) -> np.ndarray:
    """Fallback for formats without a native reader (JPEG/BMP/TGA/WebP
    DEMs and textures): Pillow when available, a clear error otherwise."""
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            f"unsupported heightmap format: {ext} (and Pillow is not "
            "installed for the generic-image fallback)") from None
    with Image.open(path) as im:
        arr = np.asarray(im)
    if arr.ndim == 3:  # RGB(A) -> luminance
        arr = (arr[..., 0] * 0.299 + arr[..., 1] * 0.587
               + arr[..., 2] * 0.114)
    return np.asarray(arr, np.float32)


def load_texture(path: str, n: int | None = None) -> np.ndarray:
    """Load an albedo texture -> (N, N, 3) float32 in [0, 1] (C18).

    PNG via the in-repo codec, anything else via Pillow. When `n` is
    given and differs from the image size, the texture is resampled with
    bilinear interpolation so it can drape any heightmap resolution.
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        raw = _image.read_png(path)
        scale = 65535.0 if raw.dtype == np.uint16 else 255.0
        img = raw.astype(np.float32) / scale
        if img.shape[2] in (1, 2):  # gray / gray+alpha -> RGB (drop alpha)
            img = np.repeat(img[:, :, :1], 3, axis=2)
        img = img[:, :, :3]
    else:
        try:
            from PIL import Image
        except ImportError:
            raise ValueError(
                f"texture format {ext} needs Pillow (only .png has a "
                "native reader)") from None
        with Image.open(path) as im:
            img = np.asarray(im.convert("RGB"), np.float32) / 255.0
    if n is not None and img.shape[:2] != (n, n):
        ys = np.linspace(0, img.shape[0] - 1, n, dtype=np.float32)
        xs = np.linspace(0, img.shape[1] - 1, n, dtype=np.float32)
        y0 = np.clip(ys.astype(np.int32), 0, img.shape[0] - 2)
        x0 = np.clip(xs.astype(np.int32), 0, img.shape[1] - 2)
        fy = (ys - y0)[:, None, None]
        fx = (xs - x0)[None, :, None]
        img = (img[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
               + img[np.ix_(y0, x0 + 1)] * (1 - fy) * fx
               + img[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
               + img[np.ix_(y0 + 1, x0 + 1)] * fy * fx)
    return np.ascontiguousarray(img, np.float32)


def _load_pgm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    # header: magic, width, height, maxval — whitespace/comment separated
    tokens, pos = [], 0
    while len(tokens) < 4:
        m = re.match(rb"\s*(?:#[^\n]*\n)*\s*(\S+)", data[pos:])
        if not m:
            raise ValueError(f"{path}: bad PGM header")
        tokens.append(m.group(1))
        pos += m.end()
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    if magic == b"P2":
        vals = np.array(data[pos:].split(), dtype=np.float32)
        return vals[: w * h].reshape(h, w)
    if magic == b"P5":
        dt = np.dtype(">u2") if maxval > 255 else np.dtype(np.uint8)
        pos += 1  # single whitespace after maxval
        return np.frombuffer(data[pos:pos + w * h * dt.itemsize], dtype=dt).reshape(h, w).astype(np.float32)
    raise ValueError(f"{path}: unsupported PGM magic {magic!r}")


def _load_esri_ascii(path: str) -> np.ndarray:
    meta, rows = {}, []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0].lower() in ("ncols", "nrows", "xllcorner", "yllcorner",
                                    "cellsize", "nodata_value"):
                if len(parts) < 2:
                    raise ValueError(
                        f"{path}: corrupt ESRI ASCII header line {parts[0]!r}")
                meta[parts[0].lower()] = float(parts[1])
            else:
                try:
                    rows.append(np.array(parts, dtype=np.float32))
                except ValueError:
                    raise ValueError(f"{path}: corrupt ESRI ASCII data "
                                     f"line starting {parts[0]!r}") from None
    # untrusted-input gate: a truncated file must not come back as a
    # silently smaller heightmap — validate against the declared grid
    if not rows:
        raise ValueError(f"{path}: ESRI ASCII grid has no data rows")
    try:
        h = np.vstack(rows)
    except ValueError:
        raise ValueError(f"{path}: truncated ESRI ASCII grid (ragged "
                         "data rows)") from None
    want = (meta.get("nrows"), meta.get("ncols"))
    if want[0] is not None and want[1] is not None \
            and h.shape != (int(want[0]), int(want[1])):
        raise ValueError(f"{path}: truncated ESRI ASCII grid — header "
                         f"declares {int(want[0])}x{int(want[1])}, data "
                         f"has {h.shape[0]}x{h.shape[1]}")
    nodata = meta.get("nodata_value")
    if nodata is not None:
        valid = h[h != nodata]
        fill = valid.min() if valid.size else 0.0
        h = np.where(h == nodata, fill, h)
    return h


def _value_noise_grid(n: int, cells: int, g: np.ndarray) -> np.ndarray:
    """Bicubic-smoothstep interpolated value noise on an n x n grid, from
    a pre-drawn (cells+1, cells+1) lattice of values."""
    t = np.linspace(0.0, cells, n, endpoint=False, dtype=np.float32)
    i = np.minimum(t.astype(np.int32), cells - 1)
    f = t - i
    s = f * f * (3.0 - 2.0 * f)  # smoothstep
    g00 = g[np.ix_(i, i)]
    g10 = g[np.ix_(i + 1, i)]
    g01 = g[np.ix_(i, i + 1)]
    g11 = g[np.ix_(i + 1, i + 1)]
    sy, sx = s[:, None], s[None, :]
    return (g00 * (1 - sy) * (1 - sx) + g10 * sy * (1 - sx)
            + g01 * (1 - sy) * sx + g11 * sy * sx)


def _octaves(n: int, seed: int, octaves: int) -> list:
    """(cells, lattice, weight) of each octave, drawn from `seed` in the
    spec's order."""
    rng = np.random.default_rng(seed)
    specs = []
    amp, cells = 1.0, 4  # amps stay python floats (f64), as in the spec
    for _ in range(octaves):
        c = min(cells, n)
        specs.append((c, rng.standard_normal((c + 1, c + 1)).astype(np.float32), amp))
        amp *= 0.55
        cells *= 2
    return specs


def procedural_terrain(n: int, seed: int = 0, octaves: int = 6,
                       z_scale: float = None, ridged: bool = True) -> np.ndarray:
    """Deterministic fBm terrain, float32 (n, n), world z units: the octave
    sum runs in the host library, equal bit for bit to
    `procedural_terrain_reference`."""
    cells, grids, amps = zip(*_octaves(n, seed, octaves))
    return normalize_heights(terrain_fbm(n, grids, cells, amps, ridged), z_scale)


def procedural_terrain_reference(n: int, seed: int = 0, octaves: int = 6,
                                 z_scale: float = None, ridged: bool = True) -> np.ndarray:
    """The numpy spec of `procedural_terrain` (the tests and chip_smoke.py
    hold the host library against it)."""
    acc = np.zeros((n, n), np.float32)
    for c, g, amp in _octaves(n, seed, octaves):
        layer = _value_noise_grid(n, c, g)
        if ridged:
            layer = 1.0 - np.abs(layer)
        acc += amp * layer
    return normalize_heights(acc, z_scale)
