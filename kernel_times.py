#!/usr/bin/env python3
"""Device times of the three kernels at the main paths' shapes, on one CUDA card.

Run from the root of a checkout:

    python3 kernel_times.py [--root DIR] [VARIANT ...]

It builds the B1, B2, B3 and B4 scenes (bench/configs.py) and prints one
JSON line per variant: the device ms of each march_pass launch of one
compact B3 frame and their sum, the render_tile kernel's device ms on the
B3 frame (backend "pallas") and on the B1 frame (torch.profiler, the kernel
alone), and on both and on B3's 16-row bands at the horizon beside the
counting instance's steps, cell tests, longest ray and bound,
each sorted round's reorder of the B3 frame and of B4's orbit frame 0 and
their unsorts (chip_smoke.py::hold_ray_sort: the kernels, their plain
version, CUB's radix sort between the same key pass and gather, and
torch's argsort and index_selects, each replayed from a CUDA graph, beside
the bytes a reorder cannot avoid), the shade_pass kernel's device ms on the
lanes of the B3 frame (untextured)
and of B4's orbit frame 0 (textured), three times each by CUDA events over
SHADE_REPS calls queued behind a spin kernel, with the 32-byte sectors its
gathers touch in either layout (chip_smoke.py::shade_sectors), the colour
pass on the same two frames' inputs (the kernel, and its plain version,
the torch maths it replaced, each replayed from a CUDA graph, beside the
bytes it cannot avoid: `color_pass`), the B3
frame's ms through each path (CUDA events, median of 5), B5's eight bands
of 270 rows on one card (CUDA events, median of 3, with the marches each
band's launches ran and each launch's device ms), B2's frame ms through
each path in turns (CUDA events, median of 5), each march_pass
launch of the B3 frame with its level-0 tail off, forced, "auto" and relaxed
at strides 4, 8 and 16 (render_frame_compact's l0_tail and relax) with the
march's bound on that frame and the primary tail launch's steps and cell
tests (bench/floor.py, from the counting instance), the
level-0 tail launches of the B3 frame (primary and shadow) and of B4's
orbit frame 0 (primary) replayed on their own inputs, the relaxed tail
launch on B3's 8,192 tail rays at each stride (device ms, and the counting
instance's steps, cell tests, longest ray and bound), the latency bound of
B4's tail launch (the probe bench/latency.py over the steps the one-lane
march takes on its longest ray, one dependent record load and cell test a
step), and the registers and spill bytes ptxas gave each kernel
(march_pass by mode), beside the card's name and power limit.

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
import importlib.util
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
    (non-counting) instances of the march kernels, of both instances of
    render_tile (timed, "_count") and of shade_pass (untextured, textured)
    in a ptxas log."""
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
            if "render_tile_kernel" in entry:  # the timed and the counting instance
                suffix = "_count" if "ILb1E" in entry else ""
                regs["render_tile_kernel" + suffix] = [int(m.group(1)), spill]
            if "shade_color_kernel" in entry:
                regs["shade_color_kernel"] = [int(m.group(1)), spill]
            if "shade_pass_kernel" in entry:  # one instance before the records
                suffix = ("_textured" if "ILb1E" in entry else
                          "_untextured" if "ILb0E" in entry else "")
                regs["shade_pass_kernel" + suffix] = [int(m.group(1)), spill]
            sort = re.search(r"(ray_(?:un)?sort_[a-z_]+)[EI]", entry)
            if sort:  # the ray sort's kernels, the last digit's scatter apart
                suffix = "_last" if "ILb1E" in entry else ""
                regs[sort.group(1) + suffix] = [int(m.group(1)), spill]
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


def color_pass(scene, cam, cfg, queued_ms, graph_ms) -> dict:
    """The colour pass of the frame replayed on its own inputs (captured
    from one compact frame): the kernel's device ms queued by events and
    replayed from a CUDA graph, and the plain version's (the torch maths the
    kernel replaced) from a graph, three times each, beside the bytes these
    inputs need (chip_smoke.py::color_bytes) over 3.35 TB/s. {} in a
    checkout without the colour pass."""
    if not importlib.util.find_spec("hmrt_tpu_torch.kernels.shade_color"):
        return {}
    from chip_smoke import color_bytes, color_calls
    from hmrt_tpu_torch.kernels.compact import render_frame_compact
    from hmrt_tpu_torch.kernels.shade_color import shade_color, shade_color_reference
    args = color_calls(lambda: render_frame_compact(scene, cam, cfg))[0]
    p, hits = args[0].shape[0], int((args[0] != 0).sum())
    nbytes = color_bytes(args)
    return {"lanes": p, "hits": hits, "textured": cfg.texture,
            "shadows": args[5] is not None, "fog": cfg.fog, "bytes": nbytes,
            "bound_ms": nbytes / 3.35e12 * 1e3,
            "kernel_queued_ms": [queued_ms(lambda: shade_color(*args), SHADE_REPS)
                                 for _ in range(3)],
            "kernel_graph_ms": [graph_ms(lambda: shade_color(*args), SHADE_REPS)
                                for _ in range(3)],
            "plain_graph_ms": [graph_ms(lambda: shade_color_reference(*args), 50)
                               for _ in range(3)]}


def tail_launch_ms(launches, march_pass, kernel_ms, event_ms) -> list:
    """Each captured tail launch replayed on its own inputs: the kernel's
    device ms (profiler), the wrapper call's ms by events and the launch's
    live rays."""
    import torch
    out = []
    for args, kw in launches:
        fn = (lambda args=args, kw=kw: march_pass(*args, **kw))
        out.append({"rays": int(args[0][0].shape[0]), "live": int((args[1][0] != 0).sum()),
                    "kernel_ms": kernel_ms(fn, "march_pass_kernel", 5),
                    "call_ms": event_ms(fn, 5)})
        torch.cuda.synchronize()
    return out


def latency_probe(launch, scene, march_pass, kernel_ms) -> dict:
    """The probe of bench/latency.py on the live rays of a captured tail
    launch: the steps the one-lane march takes on its longest ray (the
    counting instance's) and the probe's device ms over as many dependent
    steps from that ray's start, the launch's latency bound (no lane
    finishes its ray sooner), with the time of one step."""
    import torch
    from hmrt_tpu_torch.bench.latency import l0_walk
    args, kw = launch
    live = torch.nonzero(args[1][0] != 0).squeeze(1)
    sub = tuple(tuple(x.index_select(0, live).contiguous() for x in planes)
                for planes in args[:3])
    cnt = torch.empty((2, live.numel()), dtype=torch.int32, device=live.device)
    march_pass(*sub, *args[3:], **{**kw, "counts": cnt})
    k = int(torch.argmax(cnt[0]))
    chain = int(cnt[0][k])
    one = [tuple(x[k:k + 1].contiguous() for x in planes) for planes in sub[:2]]
    ms = kernel_ms(lambda: l0_walk(*one, scene, steps=chain, cell_intersect=kw["cell_intersect"]),
                   "l0_probe_kernel", 5)
    return {"chain": chain, "probe_ms": ms, "us_per_step": 1e3 * ms / chain, "bound_ms": ms}


def relaxed_tail_rays(scene, cam, cfg, march_pass, kernel_ms, tail_survivors) -> dict:
    """The relaxed instance on B3's tail rays (chip_smoke.py's 8,192 tail
    survivors) at each stride: the kernel's device ms, and from the
    counting instance its steps, cell tests and longest ray, and its bound
    (bench/floor.py: the lanes' planes against the steps' and tests'
    operations)."""
    import torch
    from hmrt_tpu_torch.bench.floor import OPS_PER_STEP, OPS_PER_TEST, bound, march_bytes
    rays, state, res, _ = tail_survivors(scene, cam, cfg)
    p = rays[0].shape[0]
    kw = dict(n=scene.n, m=scene.m, levels=scene.levels, budget=1 << 22, l0_only=True)
    if "pyr_min" in inspect.signature(march_pass).parameters:
        kw["pyr_min"] = scene.pyr_min_flat
    args = (rays, state, res, scene.pyr_flat, scene.heights, scene.corners)
    out = {"rays": p}
    for k in (4, 8, 16):
        cnt = torch.empty((2, p), dtype=torch.int32, device=rays[0].device)
        march_pass(*args, counts=cnt, relax=k, **kw)
        steps, tests = int(cnt[0].sum(dtype=torch.int64)), int(cnt[1].sum(dtype=torch.int64))
        b = bound(march_bytes(p, int(torch.count_nonzero(cnt[0]))),
                  steps * OPS_PER_STEP + tests * OPS_PER_TEST)
        out[str(k)] = {"ms": kernel_ms(lambda k=k: march_pass(*args, relax=k, **kw),
                                       "march_pass_kernel", 5),
                       "steps": steps, "tests": tests, "longest": int(cnt[0].max()),
                       "bound_ms": b[0], "bound_by": b[1]}
    return out


def fused_rows(scene, cam, cfg, scene1, cam1, cfg1, render_frame_fused, fused_work,
               kernel_ms) -> dict:
    """K3 on the B1 frame, the B3 frame and B3's 16-row bands at the horizon:
    the kernel's device ms (profiler) beside the counting instance's steps,
    cell tests, longest ray and bound (chip_smoke.py::fused_work); for the
    bands, each band's device ms from the first row with a hit down (12
    bands; a band's call by events is the host's time), the slowest one,
    and rows 609-624, the slowest before the march under the terrain."""
    import torch

    def row(sc, cm, cf, row0=None, fh=None, reps=5):
        work = fused_work(sc, cm, cf, row0, fh)
        out = {k: v for k, v in work.items() if k not in ("counts", "hit")}
        out["ms"] = kernel_ms(lambda: render_frame_fused(sc, cm, cf, row0, fh),
                              "render_tile_kernel", reps)
        return out, work["hit"]

    b1, _ = row(scene1, cam1, cfg1, reps=20)
    b3, hit3 = row(scene, cam, cfg)
    first = int(torch.nonzero(hit3.any(dim=1)).squeeze(1)[0])
    band = dataclasses.replace(cfg, height=16)
    cands = range(first, min(first + 16 * 12, cfg.height - 15), 16)
    by_row = {r0: kernel_ms(lambda r0=r0: render_frame_fused(scene, cam, band, r0, cfg.height),
                            "render_tile_kernel", 3) for r0 in cands}
    slow = max(by_row, key=by_row.get)
    bands = {"by_row_ms": by_row, "slowest_row0": slow}
    for key, r0 in (("slowest", slow), ("rows_609", 609)):
        bands[key], _ = row(scene, cam, band, r0, cfg.height, reps=10)
    return {"b1": b1, "b3": b3, "b3_bands": bands}


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
    from chip_smoke import (card_line, cub_library, event_ms, fused_work, graph_ms,
                            hold_ray_sort, kernel_ms, launch_times, median_ms, queued_ms,
                            shade_sectors, tail_launches, tail_survivors)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import hmrt_tpu_torch as T
    from hmrt_tpu_torch.api.flythrough import frame_camera, orbit_flythrough
    from hmrt_tpu_torch.bench.configs import BENCH_CONFIGS, bench_scene
    from hmrt_tpu_torch.kernels import _build
    from hmrt_tpu_torch.kernels.compact import render_frame_compact
    from hmrt_tpu_torch.kernels.march_pass import march_pass
    from hmrt_tpu_torch.kernels.raycast import render_frame_fused
    from hmrt_tpu_torch.kernels.shade_pass import shade_pass
    if args.root != str(HERE) and args.variants != ["base"]:
        raise SystemExit("variants rebuild this checkout's kernels: drop --root")

    dev = torch.device("cuda")
    card = card_line()
    b3, b1, b4 = BENCH_CONFIGS["B3"], BENCH_CONFIGS["B1"], BENCH_CONFIGS["B4"]
    b2 = BENCH_CONFIGS["B2"]
    scene, cam, _ = bench_scene(b3, device=dev)
    scene1, cam1, _ = bench_scene(b1, device=dev)
    scene2, cam2, _ = bench_scene(b2, device=dev)
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
        k3_rows = fused_rows(scene, cam, cfg_f, scene1, cam1, b1.render, render_frame_fused,
                             fused_work, kernel_ms)
        k2 = {f"shade_pass_ms_{k}": [queued_ms(lambda: shade_pass(*lanes, *inputs), SHADE_REPS)
                                     for _ in range(3)]
              for k, (lanes, inputs) in shade_cases.items()}
        colour = {"b3": color_pass(scene, cam, b3.render, queued_ms, graph_ms),
                  "b4": color_pass(scene4, cam4, b4.render, queued_ms, graph_ms)}
        # K1's tail modes on the B3 frame: each launch with the tail off,
        # forced, "auto" (the default) and relaxed (in a checkout from before
        # the tail modes, none)
        tails, tail_bounds = {}, {}
        if "l0_tail" in inspect.signature(render_frame_compact).parameters:
            from hmrt_tpu_torch.bench.floor import count_frame
            for label, kw in (("l0_tail_false", dict(l0_tail=False)),
                              ("l0_tail_true", dict(l0_tail=True)), ("l0_tail_auto", {}),
                              *((f"relax{k}", dict(l0_tail=True, relax=k))
                                for k in (4, 8, 16))):
                launches = launch_times(lambda: render_frame_compact(scene, cam, cfg_c, **kw),
                                        ("march_pass_kernel",))
                tails[label] = [ms for _, ms in launches]
                fc = count_frame(scene, cam, cfg_c, **kw)
                tail_bounds[label] = {"steps": sum(fc.totals(0)), "tests": sum(fc.totals(1)),
                                      "bound": fc.bound(),
                                      "tail_steps": fc.totals(0)[fc.n_primary - 1],
                                      "tail_tests": fc.totals(1)[fc.n_primary - 1]}
                if hasattr(fc, "launch_bound"):  # a checkout that counts dead lanes apart
                    tail_bounds[label].update(live=fc.live(),
                                              tail_bound=fc.launch_bound(fc.n_primary - 1))
        # the level-0 tail launches, replayed (B3: primary and shadow; B4
        # orbit frame 0: primary, its frame has no shadows)
        tail_ms, b4_latency = {}, {}
        if tails:
            for name, sc, cm, cf in (("b3", scene, cam, cfg_c), ("b4", scene4, cam4, b4.render)):
                launches = tail_launches(lambda: render_frame_compact(sc, cm, cf, l0_tail=True),
                                         march_pass)
                runs = tail_launch_ms(launches, march_pass, kernel_ms, event_ms)
                for label, row in zip(("primary", "shadow"), runs):
                    tail_ms[f"{name}_{label}"] = row
                if name == "b4" and importlib.util.find_spec("hmrt_tpu_torch.bench.latency"):
                    b4_latency = latency_probe(launches[0], sc, march_pass, kernel_ms)
        relaxed = relaxed_tail_rays(scene, cam, cfg_c, march_pass, kernel_ms, tail_survivors)
        frames, frames_b2 = {}, {}
        for label, cf in (("compact", cfg_c), ("fused", cfg_f), ("fused", cfg_f),
                          ("compact", cfg_c)):
            frames.setdefault(label, []).append(
                median_ms(lambda: T.render_frame(scene, cam, cf), 5)[0])
        for label in ("compact", "fused", "fused", "compact"):
            cf = dataclasses.replace(b2.render, backend="pallas" if label == "fused" else label)
            T.render_frame(scene2, cam2, cf)
            frames_b2.setdefault(label, []).append(
                median_ms(lambda: T.render_frame(scene2, cam2, cf), 5)[0])
        # B5's 8 bands of 270 rows on one card (B3's map and camera), each
        # with the marches its launches ran
        b5 = BENCH_CONFIGS["B5"].render
        band = dataclasses.replace(b5, height=b5.height // 8)
        b5_bands = []
        for r in range(8):
            def run(r=r):
                return render_frame_compact(scene, cam, band, row0=r * band.height,
                                            full_height=b5.height)
            march_pass.mode_launches.reset()
            run()
            ran = {k: v for k, v in march_pass.mode_launches.read().items() if v}
            b5_bands.append({"ms": median_ms(run, 3)[0], "ran": ran,
                             "march_ms": [ms for _, ms in launch_times(
                                 run, ("march_pass_kernel",))]})
        # each sorted round's reorder and the unsorts of the B3 frame and of
        # B4's orbit frame 0 (in a checkout from before the ray sort, none)
        sort_rounds = {}
        if importlib.util.find_spec("hmrt_tpu_torch.kernels.ray_sort"):
            cub = cub_library()
            sort_rounds = {"b3": hold_ray_sort("B3", lambda: render_frame_compact(
                               scene, cam, cfg_c), card, cub),
                           "b4": hold_ray_sort("B4 orbit frame 0", lambda: render_frame_compact(
                               scene4, cam4, b4.render), card, cub)}
        print(json.dumps({
            "root": args.root, "variant": spec, "card": card,
            "ray_sort_rounds": sort_rounds,
            "march_pass_ms_per_launch": [ms for _, ms in per_launch],
            "march_pass_ms_per_frame": sum(ms for _, ms in per_launch),
            "render_tile_ms_b3": k3, "render_tile_ms_b1": k3_b1, "render_tile": k3_rows,
            **k2,
            "color_pass": colour,
            "march_pass_ms_per_launch_by_tail": tails,
            "march_bound_by_tail": tail_bounds,
            "tail_launch_ms": tail_ms,
            "b4_tail_latency": b4_latency,
            "relaxed_tail_rays": relaxed,
            "shade_sectors": sectors,
            "frame_ms_compact": frames["compact"], "frame_ms_fused": frames["fused"],
            "b2_frame_ms_compact": frames_b2["compact"], "b2_frame_ms_fused": frames_b2["fused"],
            "b5_bands": b5_bands,
            "registers": registers(log)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
