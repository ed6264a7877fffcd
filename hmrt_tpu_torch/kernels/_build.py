"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each of `csrc/*.cu` compiles to an object file, all at once in parallel
nvcc processes, and the objects link into one shared library with a plain
C interface, on first use, in `build/hmrt_tpu_torch_kernels/` at the root
of the checkout. The file name carries a hash of the sources and flags, so
an edited source builds anew and an unchanged one is loaded as it is.
Nothing here runs at import time: the CPU tests import every module on a
machine without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hmrt_tpu_torch_kernels"

# Exact arithmetic: no FMA contraction, IEEE division and square root. The
# march's hit decisions depend on them (a 1-ulp change flips grazing hits).
NVCC_FLAGS = ["-O3", "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
              "-std=c++17", "-Xcompiler", "-fPIC",
              "-gencode", "arch=compute_90a,code=sm_90a", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C signature of every kernel entry point: argument types, in order
SIGNATURES = {
    # 24 state/ray planes, pyr_flat, corners, pyr_min or null; p m levels
    # budget intersector mode stride; box_lo box_hi; tail flag or null;
    # group; tally or null, ray counter, counts or null, stream
    "hmrt_march_pass": [_P] * 27 + [_I] * 7 + [_F] * 2 + [_P] + [_I] + [_P] * 4,
    # hit hx hy fx fy shade_rec albedo_rec, 6 outputs; p c (cells a side); stream
    "hmrt_shade_pass": [_P] * 13 + [_I] * 2 + [_P],
    # params pyr corners gx gy albedo, color hit depth normal cell;
    # H W full_h n m levels intersector phong shadows fog;
    # ambient specular shininess fog_density box_lo box_hi;
    # pixel counter, counts or null, stream
    "hmrt_render_tile": [_P] * 11 + [_I] * 10 + [_F] * 6 + [_P] * 3,
    # ray, t, cell, corners; m intersector steps; box_lo box_hi; t_o i_o stream
    "hmrt_l0_probe": [_P] * 4 + [_I] * 3 + [_F] * 2 + [_P] * 3,
}


def find_nvcc() -> str:
    """Path of nvcc in the CUDA toolkit torch finds ($CUDA_HOME, $CUDA_PATH,
    nvcc on PATH, or the default install). Raises when there is none."""
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not nvcc.is_file():
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                           "hmrt_tpu_torch cannot be built")
    return str(nvcc)


def build(src_dir: Path, build_dir: Path) -> Path:
    """Compile src_dir/*.cu (one nvcc each, run in parallel) and link them
    into one shared library, once per content hash; return its path. The
    compilers' output, with ptxas' register counts, goes to `<stem>.log`.
    Raises on any failure."""
    srcs = sorted(src_dir.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources in {src_dir}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(src_dir.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    stem = f"hmrt_kernels_{h.hexdigest()[:16]}"
    lib = build_dir / f"{stem}.so"
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{stem}.{os.getpid()}"
    objs = [build_dir / f"{tag}.{src.stem}.o" for src in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, o in zip(srcs, objs)]
    outs = [proc.communicate()[0] for proc in procs]
    tmp = build_dir / f"{tag}.tmp"
    failed = [(src.name, proc.returncode, out)
              for src, proc, out in zip(srcs, procs, outs) if proc.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        outs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(("link", link.returncode, outs[-1]))
    (build_dir / f"{stem}.log").write_text("".join(outs))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        name, rc, out = failed[0]
        raise RuntimeError(f"nvcc failed on {name} (exit {rc}):\n{out[-4000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent builder sees all or nothing
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use; argtypes set from
    SIGNATURES. Raises when it cannot be built or loaded."""
    lib = ctypes.CDLL(str(build(CSRC, BUILD_DIR)))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def device_of(tensors) -> torch.device:
    """The one device all `tensors` live on; raises if they are on several."""
    devs = {x.device for x in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    return devs.pop()
