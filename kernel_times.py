#!/usr/bin/env python3
"""Device times of the three kernels at the main paths' shapes, on one CUDA card.

Run from the root of a checkout:

    python3 kernel_times.py [--root DIR] [VARIANT ...]

It builds the B1, B3 and B4 scenes (bench/configs.py) and prints one JSON
line per variant: the device ms of each march_pass launch of one compact B3
frame and their sum, the render_tile kernel's device ms on the B3 frame
(backend "pallas") and on the B1 frame (torch.profiler, the kernel alone),
the shade_pass kernel's device ms on the lanes of the B3 frame (untextured)
and of B4's orbit frame 0 (textured), three times each by CUDA events over
SHADE_REPS calls queued behind a spin kernel, with the 32-byte sectors its
gathers touch in either layout (chip_smoke.py::shade_sectors), the B3
frame's ms through each path (CUDA events, median of 5), each march_pass
launch of the B3 frame with its level-0 tail off, forced, "auto" and relaxed
at strides 4, 8 and 16 (render_frame_compact's l0_tail and relax), and the
registers and spill bytes ptxas gave each kernel (march_pass by mode),
beside the card's name and power limit.

--root DIR imports hmrt_tpu_torch from another checkout, e.g. an older
commit unpacked with `git archive` into a directory that .gitignore lists,
so two versions can be timed on one card in one call.

A VARIANT is "base" (the kernels as they are) or NAME=VALUE[,NAME=VALUE]:
the kernels are rebuilt from a copy of csrc/ in which each design constant
`constexpr int NAME = ...;` takes VALUE (e.g. RING=2,CHUNK=128); the
sources of the checkout are not changed. Variants need the checkout's own
package (no --root).
"""

import argparse
import ctypes
import dataclasses
import inspect
import json
import re
import shutil
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SHADE_REPS = 200   # shade_pass calls per timing (~40-150 us each)


def variant_library(build, spec: str):
    """The kernel library built from csrc/ with the constants of `spec`
    replaced, and its ptxas log."""
    src = Path(build.CSRC)
    out = Path(build.BUILD_DIR) / "variants" / re.sub(r"[^A-Za-z0-9]+", "_", spec)
    shutil.rmtree(out, ignore_errors=True)
    (out / "csrc").mkdir(parents=True)
    for f in src.iterdir():
        text = f.read_text()
        for item in spec.split(","):
            name, value = item.split("=")
            text = re.sub(rf"(constexpr int {name} = )\d+;", rf"\g<1>{int(value)};", text)
        (out / "csrc" / f.name).write_text(text)
    missing = [item.split("=")[0] for item in spec.split(",")
               if not any(re.search(rf"constexpr int {item.split('=')[0]} = ",
                                    f.read_text()) for f in src.iterdir())]
    if missing:
        raise ValueError(f"no design constant named {missing} in {src}")
    lib = ctypes.CDLL(str(build.build(out / "csrc", out)))
    for name, argtypes in build.SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib, sorted(out.glob("*.log"))[-1].read_text()


def registers(log: str) -> dict:
    """{kernel name: [registers, bytes of spill stores]} of the timed
    (non-counting) instances of the march kernels and of both instances of
    shade_pass (untextured, textured) in a ptxas log."""
    regs = {}
    entry, spill = None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            if "march_pass_kernel" in entry and "ILb1E" not in entry:
                # one timed instance per mode (march_pass.cu MODE_*), or one
                # before the tail modes
                mode = re.search(r"ILb0ELi(\d)E", entry)
                suffix = {None: "", "0": "", "1": "_l0", "2": "_relax"}[mode and mode.group(1)]
                regs["march_pass_kernel" + suffix] = [int(m.group(1)), spill]
            if "render_tile_kernel" in entry and "ILb1E" not in entry:
                regs["render_tile_kernel"] = [int(m.group(1)), spill]
            if "shade_pass_kernel" in entry:  # one instance before the records
                suffix = ("_textured" if "ILb1E" in entry else
                          "_untextured" if "ILb0E" in entry else "")
                regs["shade_pass_kernel" + suffix] = [int(m.group(1)), spill]
    return regs


def shade_lanes(scene, cam, cfg):
    """(hit, hx, hy, fx, fy) of the frame's primary march, the lanes the
    compact path hands the shade pass."""
    from hmrt_tpu_torch.kernels.compact import (FIRST_BUDGET, ROUND_BUDGET, ROUNDS,
                                                hit_points, init_state, march_rounds,
                                                primary_rays)
    rays = primary_rays(cam, cfg)
    st = init_state(rays, None, scene.pyr_flat[-1], n=scene.n, m=scene.m, levels=scene.levels)
    hit_i, t_hit, hx, hy = march_rounds(rays, st, scene, cell_intersect=cfg.cell_intersect,
                                        clip=None, first_budget=FIRST_BUDGET, rounds=ROUNDS,
                                        round_budget=ROUND_BUDGET, moving=(3, 4, 5))
    _, fx, fy = hit_points(rays, hit_i != 0, t_hit, hx, hy)
    return hit_i, hx, hy, fx, fy


def shade_inputs(scene, textured: bool) -> tuple:
    """The scene arrays shade_pass takes after the lanes: the per-cell
    records, or in a checkout from before them the gradient planes and the
    planar albedo."""
    if hasattr(scene, "shade_rec"):
        return scene.shade_rec, scene.albedo_rec if textured else None
    return scene.gx, scene.gy, scene.albedo if textured else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout to import hmrt_tpu_torch from")
    ap.add_argument("variants", nargs="*", default=["base"])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from chip_smoke import (card_line, kernel_ms, launch_times, median_ms, queued_ms,
                            shade_sectors)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import hmrt_tpu_torch as T
    from hmrt_tpu_torch.api.flythrough import frame_camera, orbit_flythrough
    from hmrt_tpu_torch.bench.configs import BENCH_CONFIGS, bench_scene
    from hmrt_tpu_torch.kernels import _build
    from hmrt_tpu_torch.kernels.compact import render_frame_compact
    from hmrt_tpu_torch.kernels.raycast import render_frame_fused
    from hmrt_tpu_torch.kernels.shade_pass import shade_pass
    if args.root != str(HERE) and args.variants != ["base"]:
        raise SystemExit("variants rebuild this checkout's kernels: drop --root")

    dev = torch.device("cuda")
    card = card_line()
    b3, b1, b4 = BENCH_CONFIGS["B3"], BENCH_CONFIGS["B1"], BENCH_CONFIGS["B4"]
    scene, cam, _ = bench_scene(b3, device=dev)
    scene1, cam1, _ = bench_scene(b1, device=dev)
    scene4, _, terr4 = bench_scene(b4, device=dev)
    cam4 = frame_camera(orbit_flythrough(b4.map_n, float(terr4.max()), b4.frames, device=dev), 0)
    shade_cases = {"b3": (shade_lanes(scene, cam, b3.render), shade_inputs(scene, False)),
                   "b4_textured": (shade_lanes(scene4, cam4, b4.render),
                                   shade_inputs(scene4, True))}
    sectors = {k: shade_sectors(lanes[0] != 0, lanes[1], lanes[2], sc.n, k != "b3")
               for (k, (lanes, _)), sc in zip(shade_cases.items(), (scene, scene4))}
    cfg_c = b3.render
    cfg_f = dataclasses.replace(cfg_c, backend="pallas")
    base_lib = _build.library()
    base_log = sorted(Path(_build.BUILD_DIR).glob("*.log"))[-1].read_text()
    for spec in args.variants:
        if spec == "base":
            lib, log = base_lib, base_log
        else:
            lib, log = variant_library(_build, spec)
        _build.library = lambda lib=lib: lib
        per_launch = launch_times(lambda: T.render_frame(scene, cam, cfg_c),
                                  ("march_pass_kernel",))
        k3 = kernel_ms(lambda: render_frame_fused(scene, cam, cfg_f), "render_tile_kernel", 5)
        k3_b1 = kernel_ms(lambda: render_frame_fused(scene1, cam1, b1.render),
                          "render_tile_kernel", 20)
        k2 = {f"shade_pass_ms_{k}": [queued_ms(lambda: shade_pass(*lanes, *inputs), SHADE_REPS)
                                     for _ in range(3)]
              for k, (lanes, inputs) in shade_cases.items()}
        # K1's tail modes on the B3 frame: each launch with the tail off,
        # forced, "auto" (the default) and relaxed (in a checkout from before
        # the tail modes, none)
        tails = {}
        if "l0_tail" in inspect.signature(render_frame_compact).parameters:
            for label, kw in (("l0_tail_false", dict(l0_tail=False)),
                              ("l0_tail_true", dict(l0_tail=True)), ("l0_tail_auto", {}),
                              *((f"relax{k}", dict(l0_tail=True, relax=k))
                                for k in (4, 8, 16))):
                launches = launch_times(lambda: render_frame_compact(scene, cam, cfg_c, **kw),
                                        ("march_pass_kernel",))
                tails[label] = [ms for _, ms in launches]
        frames = {}
        for label, cf in (("compact", cfg_c), ("fused", cfg_f), ("fused", cfg_f),
                          ("compact", cfg_c)):
            frames.setdefault(label, []).append(
                median_ms(lambda: T.render_frame(scene, cam, cf), 5)[0])
        print(json.dumps({
            "root": args.root, "variant": spec, "card": card,
            "march_pass_ms_per_launch": [ms for _, ms in per_launch],
            "march_pass_ms_per_frame": sum(ms for _, ms in per_launch),
            "render_tile_ms_b3": k3, "render_tile_ms_b1": k3_b1, **k2,
            "march_pass_ms_per_launch_by_tail": tails,
            "shade_sectors": sectors,
            "frame_ms_compact": frames["compact"], "frame_ms_fused": frames["fused"],
            "registers": registers(log)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
