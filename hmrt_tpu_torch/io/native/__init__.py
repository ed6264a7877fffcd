"""The host library: fBm terrain, PNG unfilter, and raw heightmap tiles.

Counterpart of `hmrt_tpu/io/native/`. `hmrt_native.cpp` here is the
port's own C++ (nothing of the JAX package is loaded or linked): its
`terrain_fbm` and `png_unfilter`, with a plain C interface, build with g++
on first use, never at import, into `build/hmrt_tpu_torch_native/` at the
root of the checkout. The file name carries a hash of the source, the
flags, the compiler's version and the machine, so a library built on one
host is never loaded on another. A failed build raises with the
compiler's output: the port has no quiet fallback to the numpy specs,
which the tests and `chip_smoke.py` call by name
(`io/heightmap.py::procedural_terrain_reference`, `io/image.py::_unfilter`).

Not ported from the JAX library:
  - `zlib_inflate`: nothing in either package calls it; both decompress
    IDAT with Python's `zlib`;
  - `rawmap_*`: they return what the numpy memmap `RawTileMap` below
    returns, the same edge-clamped tiles, and the JAX class falls back to
    exactly that;
  - `build_pyramid_host`: only a test calls it, and
    `core/pyramid.py::build_pyramid_flat(..., device="cpu")` is the port's
    host pyramid.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().with_name("hmrt_native.cpp")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "hmrt_tpu_torch_native"

# -ffp-contract=off: terrain_fbm must round every multiply and add as numpy
# does to equal its spec bit for bit. No -march=native: the library may be
# built on one x86-64 host and its build directory copied to another.
# std::thread, not OpenMP: no second threading runtime in the process.
GXX_FLAGS = ["-O3", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
#: C signature of each entry point: argument types, in order
SIGNATURES = {
    # raw out h stride bpp
    "png_unfilter": [_P, _P, _I64, _I64, ctypes.c_int],
    # grids offs cells amps octaves n ridged out
    "terrain_fbm": [_P, _P, _P, _P, _I64, _I64, ctypes.c_int, _P],
}


def compiler_version(gxx: str = "g++") -> str:
    """`g++ -dumpfullversion`; raises when there is no g++."""
    try:
        return subprocess.run([gxx, "-dumpfullversion"], capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError) as e:
        raise RuntimeError(f"g++ not found or not working ({e}); the host library of "
                           "hmrt_tpu_torch cannot be built") from None


def library_path(flags=GXX_FLAGS, build_dir: Path = BUILD_DIR) -> Path:
    """Where the library built from SRC with `flags` lives: the name
    carries a hash of the source, the flags, g++'s version and the
    machine."""
    h = hashlib.sha256(" ".join(flags).encode())
    for part in (compiler_version(), platform.machine()):
        h.update(b"\0" + part.encode())
    h.update(b"\0" + SRC.read_bytes())
    return build_dir / f"hmrt_native_{h.hexdigest()[:16]}.so"


def build(flags=GXX_FLAGS, build_dir: Path = BUILD_DIR) -> Path:
    """Compile SRC with g++ once per hash and return the library's path.
    Concurrent builders each write their own temporary file and move it in
    place atomically. Raises with the compiler's output on a failure."""
    lib = library_path(flags, build_dir)
    if lib.exists():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *flags, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SRC.name} (exit {proc.returncode}):\n"
                           f"{(proc.stdout + proc.stderr)[-4000:]}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded host library, built on first use; argtypes set from
    SIGNATURES. Raises when it cannot be built or loaded."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def terrain_fbm(n: int, grids: list, cells: list, amps: list, ridged: bool) -> np.ndarray:
    """The fBm octave sum of `procedural_terrain_reference` as float32
    (n, n), bit for bit: octave o interpolates the (cells[o]+1)^2 lattice
    grids[o] and adds amps[o] times it (ridged: 1 - |it|)."""
    if n < 1 or not len(grids) == len(cells) == len(amps):
        raise ValueError(f"terrain_fbm: n={n}, {len(grids)} grids, {len(cells)} cell "
                         f"counts, {len(amps)} weights")
    for g, c in zip(grids, cells):
        if not 1 <= c <= n or np.shape(g) != (c + 1, c + 1):
            raise ValueError(f"terrain_fbm: a lattice of shape {np.shape(g)} for {c} cells "
                             f"on an {n}-sample grid")
    flat = np.concatenate([np.ascontiguousarray(g, np.float32).ravel() for g in grids])
    sizes = np.array([(c + 1) ** 2 for c in cells], np.int64)
    offs = np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int64)
    cells_arr = np.asarray(cells, np.int64)
    amps_arr = np.asarray(amps, np.float64)
    out = np.empty((n, n), np.float32)
    library().terrain_fbm(flat.ctypes.data, offs.ctypes.data, cells_arr.ctypes.data,
                          amps_arr.ctypes.data, len(grids), n, int(bool(ridged)),
                          out.ctypes.data)
    return out


def png_unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """PNG scanlines unfiltered: `raw` holds h rows of one filter byte and
    `stride` bytes; returns uint8 (h, stride), equal to `io/image.py::
    _unfilter`. Raises ValueError on a filter byte outside 0-4."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.shape != (h * (stride + 1),) or bpp < 1:
        raise ValueError(f"png_unfilter: {raw.shape} bytes for {h} rows of 1 + {stride}, "
                         f"{bpp} bytes a pixel")
    out = np.empty((h, stride), np.uint8)
    if library().png_unfilter(raw.ctypes.data, out.ctypes.data, h, stride, bpp) != 0:
        types = raw[::stride + 1]
        raise ValueError(f"bad PNG filter type {types[types > 4][0]}")
    return out


class RawTileMap:
    """mmap'd square raw-f32 heightmap with edge-clamped tile extraction."""

    def __init__(self, path: str):
        mm = np.memmap(path, dtype=np.float32, mode="r")
        n = int(round(len(mm) ** 0.5))
        if n * n != len(mm):
            raise ValueError(f"{path}: raw f32 file is not square")
        self._mm = mm.reshape(n, n)
        self.side = n

    def tile(self, y0: int, x0: int, th: int, tw: int) -> np.ndarray:
        """Samples [y0, y0+th) x [x0, x0+tw), indices clamped to the map."""
        ys = np.clip(np.arange(y0, y0 + th), 0, self.side - 1)
        xs = np.clip(np.arange(x0, x0 + tw), 0, self.side - 1)
        return np.asarray(self._mm[np.ix_(ys, xs)], np.float32)

    def close(self):
        self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
