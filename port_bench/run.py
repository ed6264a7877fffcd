"""One run of one cell of the benchmark.

    python -m port_bench.run --workload B3.flyover --seed 7 --seconds 20 --trace 0

Set-up makes the configuration's terrain (and albedo) on the card from the
configuration alone, builds the scene with the port's `make_scene`, makes
every camera of the traffic's lap and renders the warm-up frames. The
window is a closed loop: frame i is `render_frame(scene, cams[i % lap],
config)` and a synchronise, timed on the host clock from the call to the
synchronise's return, until `--seconds` have passed. `--trace 1` then
renders the loop's next `trace_frames` frames under torch.profiler, and
`named_frames` more with Python stacks to name the device's idle gaps
(the stacks slow the host), and reports the per-layer metrics instead of
the end-to-end ones.

After the window the output check compares, for each lap view drawn from
the seed, the last frame of the window that rendered it with the plain
reference (`reference/render.py`), worked out again from the same
heightmap, albedo and cameras, once the program's state is freed. The
last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, with --trace 1 the breakdown, and last the
numbers compared with their limits, which also close standard error.

A run exits non-zero with no result when there is no CUDA card (or fewer
than the cell asks for), and when jax, jaxlib, flax or the JAX package
hmrt_tpu is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from port_bench import cells, hostinfo, paths, terrain
from port_bench import trace as trace_mod

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "hmrt_tpu")
IMPORTED_AT = time.time()


@dataclasses.dataclass
class Ctx:
    """What a metric reads: the window's frame times, the run's facts,
    the trace of a traced run, and the cell's configuration and traffic."""
    frame_s: list
    window_s: float
    facts: dict
    trace: object
    config: dict
    traffic: dict


def process_start() -> float:
    """Wall-clock time at which this process started (from /proc)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
    except OSError:
        return IMPORTED_AT
    return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))


def banned_modules() -> list:
    """Loaded modules whose top-level name is one the port must not load."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(BANNED))


def compare(color, hit, ref_color, ref_hit, tol: float) -> dict:
    """The numbers compared for one frame: pixels whose hit differs, and
    pixels whose colour differs by more than `tol` in some channel."""
    return {"hit_px": int((hit != ref_hit).sum()),
            "color_px": int(((color - ref_color).abs().amax(-1) > tol).sum())}


def run_cell(cell: cells.Cell, seed: int, seconds: float, traced: bool, device, log,
             render_frame=None) -> dict:
    """Set-up, window and output check of one run on `device`; returns the
    result line's object. `render_frame` replaces the port's entry (the
    tests break the timed path with it)."""
    import torch

    from hmrt_tpu_torch.config import RenderConfig
    from hmrt_tpu_torch.types import Camera, Light
    from hmrt_tpu_torch.api.scene import make_scene
    if render_frame is None:
        from hmrt_tpu_torch.core.renderer import render_frame
    from port_bench.reference.render import render as reference

    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    config, traffic = cell.config, cell.traffic
    facts = {}
    t = time.perf_counter()
    heights, albedo = terrain.make_inputs(config, device)
    heights_np = heights.cpu().numpy()
    albedo_np = None if albedo is None else albedo.cpu().numpy()
    del heights, albedo
    facts["inputs_s"] = time.perf_counter() - t
    n = heights_np.shape[0]
    zmax = float(heights_np.max())
    rc = RenderConfig(**config["render"])
    light = Light.create(**config["light"], device=device)
    t = time.perf_counter()
    scene = make_scene(heights_np, albedo=albedo_np, light=light, device=device)
    sync()
    facts["scene_build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    eyes, targets, checked = paths.seeded_lap(traffic, n, zmax, seed)
    fov = float(traffic["fov_deg"])
    cams = [Camera.create(eye=tuple(e), target=tuple(g), fov_y_deg=fov, device=device)
            for e, g in zip(eyes, targets)]
    lap = len(cams)
    facts["cameras_s"] = time.perf_counter() - t
    t = time.perf_counter()
    warm = int(traffic["warmup_frames"])
    for j in range(warm):
        render_frame(scene, cams[j * lap // warm], rc)
        sync()
    facts["warmup_s"] = time.perf_counter() - t
    facts["setup_s"] = time.time() - process_start()
    print("setup: " + ", ".join(f"{k} {v:.3f}" for k, v in facts.items()), file=log)

    print(f"card state before the window: {hostinfo.card_state()}", file=log)
    # the output check keeps the last frame the window renders at each
    # checked lap view, so that it judges the window's end, every lap before
    # it having reused the program's buffers
    keep = set(checked)
    kept, frame_s, frame_end = {}, [], []
    cpu_start = hostinfo.current_cpu()
    begin = time.perf_counter()
    goal = begin + seconds
    i = 0
    while True:
        t0 = time.perf_counter()
        fr = render_frame(scene, cams[i % lap], rc)
        sync()
        t1 = time.perf_counter()
        frame_s.append(t1 - t0)
        frame_end.append(t1 - begin)
        if i % lap in keep:
            kept[i % lap] = (i, fr)
        i += 1
        if t1 >= goal:
            break
    window_s = t1 - begin
    cpu_end = hostinfo.current_cpu()
    print(f"card state after the window: {hostinfo.card_state()}", file=log)
    print(f"cpu at window start {cpu_start}, at end {cpu_end}", file=log)
    fifths = np.histogram(frame_end, bins=5, range=(0.0, window_s))[0] / (window_s / 5)
    print("frames/s by fifth of the window: " + " ".join(f"{v:.2f}" for v in fifths), file=log)
    q = np.percentile(frame_s, [5, 25, 50, 75, 95, 100]) * 1e3
    print("frame ms p5 p25 p50 p75 p95 max: " + " ".join(f"{v:.3f}" for v in q), file=log)
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    tr = None
    if traced:
        # the next frames of the same loop, after the window: first without
        # Python stacks, for the device's times (the stacks slow the host),
        # then a few with them, to name the idle gaps
        first = int(traffic["trace_frames"])
        tr, traced_hits = _traced(torch, render_frame, scene, cams, rc, range(i, i + first),
                                  sync, cuda, stacks=False)
        named, _ = _traced(torch, render_frame, scene, cams, rc,
                           range(i + first, i + first + int(traffic["named_frames"])),
                           sync, cuda, stacks=True)
        tr.gaps = named.gaps
        facts["traced_hit_pixels"] = [int(h.sum()) for h in traced_hits]
        print(f"traced {tr.frames} frames: {tr.kernels} kernels, {len(tr.ops)} device ops, "
              f"{tr.window_s:.4f} s, {tr.busy_s:.4f} s busy; with stacks {named.frames} "
              f"frames in {named.window_s:.4f} s; hit pixels a frame "
              f"{np.mean(facts['traced_hit_pixels']):.0f} of {rc.width * rc.height}", file=log)
        del traced_hits

    # the output check, once the program's state is freed
    outputs = {view: (pos, fr.color, fr.hit) for view, (pos, fr) in kept.items()}
    del scene, cams, kept, fr
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    h = torch.from_numpy(heights_np).to(device)
    alb = None if albedo_np is None else torch.from_numpy(albedo_np).to(device)
    check = config["check"]
    worst, failed = {k: 0 for k in check["limits"]}, 0
    for view in sorted(outputs):
        pos, color, hit = outputs[view]
        ref_color, ref_hit = reference(h, alb, eyes[view], targets[view], fov,
                                       config["render"], config["light"])
        nums = compare(color, hit, ref_color, ref_hit, float(check["color_tol"]))
        print(f"checked frame {pos} of {len(frame_s)} (lap view {view}): {nums}", file=log)
        failed += any(nums[k] > lim for k, lim in check["limits"].items())
        worst = {k: max(worst[k], nums[k]) for k in worst}
    sync()
    facts["check_s"] = time.perf_counter() - t
    print(f"output check: {len(outputs)} frames in {facts['check_s']:.3f} s", file=log)

    ctx = Ctx(frame_s=frame_s, window_s=window_s, facts=facts, trace=tr, config=config,
              traffic=traffic)
    metrics = {}
    for m in cell.metrics:
        if m.per_layer == traced:
            v = m.read(ctx)
            if v is not None:
                metrics[m.name] = {"value": float(v), "unit": m.unit}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell.chips, "memory_peak_bytes": memory_peak}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
    out = {"correct": bool(outputs) and failed == 0, "attempted": len(frame_s),
           "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None:
        out["breakdown"] = tr.breakdown()
    out["checks"] = {k: {"value": worst[k], "limit": lim} for k, lim in check["limits"].items()}
    return out


def _traced(torch, render_frame, scene, cams, rc, frames, sync, cuda: bool, stacks: bool):
    """Render `frames` (window positions) under torch.profiler, each in the
    FRAME span with the port's call in RENDER; returns the Trace read back
    and the frames' hit masks."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    hits = []
    with torch.profiler.profile(activities=acts, with_stack=stacks) as prof:
        for k in frames:
            with torch.profiler.record_function(trace_mod.FRAME):
                with torch.profiler.record_function(trace_mod.RENDER):
                    f = render_frame(scene, cams[k % len(cams)], rc)
                sync()
            hits.append(f.hit)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return trace_mod.read(path), hits
    finally:
        os.unlink(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    log = sys.stderr
    cell = cells.resolve(args.workload, ROOT / "BENCHMARK.json")
    node = hostinfo.card_node()
    print(f"allowed CPUs {sorted(os.sched_getaffinity(0))}", file=log)
    print(f"card: pci {node['pci']}, local_cpulist {node['local_cpulist']}, "
          f"numa_node {node['numa_node']}", file=log)
    t_imp = time.time()
    import torch
    import hmrt_tpu_torch  # noqa: F401  (the port's import, timed as set-up)
    imported = time.time() - t_imp
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"error: {cell.name} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=log)
        return 3
    device = torch.device("cuda", 0)
    t = time.time()
    torch.cuda.init()
    torch.empty(1, device=device)
    print(f"set-up before run_cell: interpreter and harness {t_imp - process_start():.3f} s, "
          f"torch and the port imported {imported:.3f} s, CUDA context {time.time() - t:.3f} s",
          file=log)
    print(f"card: {torch.cuda.get_device_name(device)}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", file=log)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, log)
    found = banned_modules()
    if found:
        print(f"error: modules loaded that the port must not load: {found}", file=log)
        return 4
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=log)
    log.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
