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

A cell whose `chips` is above 1 runs as that many ranks, one a card,
through the port's band-sharded path (sharded.py); this process starts
them, reads the metrics from rank 0's readings and prints the result.

A run exits non-zero with no result when there is no CUDA card (3; also
with fewer than the cell asks for), when jax, jaxlib, flax or the JAX
package hmrt_tpu is loaded once the window has closed, in this process or
in any rank (4), and when a rank raises, dies or outlasts its time (5).
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


@dataclasses.dataclass
class Setup:
    """What set-up hands the window: the scene, the render settings, the
    seeded lap's cameras (with their eyes, targets, field of view and the
    checked views), the inputs the output check reuses, and the facts."""
    scene: object
    rc: object
    cams: list
    eyes: object
    targets: object
    checked: list
    fov: float
    heights_np: object
    albedo_np: object
    facts: dict


def set_up(config: dict, traffic: dict, seed: int, device, sync, render, mesh=None) -> Setup:
    """Set-up of a run on `device`, each step timed into the facts: the
    configuration's terrain (and albedo) made on the card, the scene built
    with the port's `make_scene` (`scene_build_s`), every camera of the
    seeded lap, and the warm-up frames, each `render(scene, camera, rc)`
    and `sync()`. On a `mesh` rank 0 alone makes the inputs and builds the
    scene, the port's `replicate_scene` gives every rank the same scene
    (`scene_build_s` then runs to a barrier after a synchronise), rank 0
    shares the map's size and height, and a barrier ends the warm-up."""
    from hmrt_tpu_torch.api.scene import make_scene
    from hmrt_tpu_torch.config import RenderConfig
    from hmrt_tpu_torch.types import Camera, Light

    lead = mesh is None or mesh.rank == 0
    facts = {}
    heights_np = albedo_np = scene = light = None
    if lead:
        t = time.perf_counter()
        heights, albedo = terrain.make_inputs(config, device)
        heights_np = heights.cpu().numpy()
        albedo_np = None if albedo is None else albedo.cpu().numpy()
        del heights, albedo
        facts["inputs_s"] = time.perf_counter() - t
        light = Light.create(**config["light"], device=device)
    rc = RenderConfig(**config["render"])
    if mesh is not None:
        mesh.barrier()
    t = time.perf_counter()
    if lead:
        scene = make_scene(heights_np, albedo=albedo_np, light=light, device=device)
    if mesh is not None:
        from hmrt_tpu_torch.distrib.mesh import replicate_scene
        scene = replicate_scene(scene, mesh)
    sync()
    if mesh is not None:
        mesh.barrier()
    facts["scene_build_s"] = time.perf_counter() - t
    n, zmax = (heights_np.shape[0], float(heights_np.max())) if lead else (None, None)
    if mesh is not None:
        from hmrt_tpu_torch.distrib.mesh import broadcast_object
        n, zmax = broadcast_object((n, zmax), mesh)
    t = time.perf_counter()
    eyes, targets, checked = paths.seeded_lap(traffic, n, zmax, seed)
    fov = float(traffic["fov_deg"])
    cams = [Camera.create(eye=tuple(e), target=tuple(g), fov_y_deg=fov, device=device)
            for e, g in zip(eyes, targets)]
    facts["cameras_s"] = time.perf_counter() - t
    t = time.perf_counter()
    warm, lap = int(traffic["warmup_frames"]), len(cams)
    for j in range(warm):
        render(scene, cams[j * lap // warm], rc)
        sync()
    if mesh is not None:
        mesh.barrier()
    facts["warmup_s"] = time.perf_counter() - t
    return Setup(scene=scene, rc=rc, cams=cams, eyes=eyes, targets=targets, checked=checked,
                 fov=fov, heights_np=heights_np, albedo_np=albedo_np, facts=facts)


def run_cell(cell: cells.Cell, seed: int, seconds: float, traced: bool, device, log,
             render_frame=None) -> dict:
    """Set-up, window and output check of one run on `device`; returns the
    result line's object. `render_frame` replaces the port's entry (the
    tests break the timed path with it)."""
    import torch

    if render_frame is None:
        from hmrt_tpu_torch.core.renderer import render_frame

    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    config, traffic = cell.config, cell.traffic
    su = set_up(config, traffic, seed, device, sync, render_frame)
    scene, rc, cams, facts = su.scene, su.rc, su.cams, su.facts
    lap = len(cams)
    facts["setup_s"] = time.time() - process_start()
    print("setup: " + ", ".join(f"{k} {v:.3f}" for k, v in facts.items()), file=log)

    print(f"card state before the window: {hostinfo.card_state()}", file=log)
    # the output check keeps the last frame the window renders at each
    # checked lap view, so that it judges the window's end, every lap before
    # it having reused the program's buffers
    keep = set(su.checked)
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
    log_window(frame_s, frame_end, window_s, log)
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    tr = None
    if traced:
        tr, named, traced_hits = trace_after_window(
            torch, lambda k: render_frame(scene, cams[k % lap], rc), i, traffic, sync, cuda)
        facts["traced_hit_pixels"] = [int(h.sum()) for h in traced_hits]
        print(f"traced {tr.frames} frames: {tr.kernels} kernels, {len(tr.ops)} device ops, "
              f"{tr.window_s:.4f} s, {tr.busy_s:.4f} s busy; with stacks {named.frames} "
              f"frames in {named.window_s:.4f} s; hit pixels a frame "
              f"{np.mean(facts['traced_hit_pixels']):.0f} of {rc.width * rc.height}", file=log)
        del traced_hits

    # the output check, once the program's state is freed
    outputs = {view: (pos, fr.color, fr.hit) for view, (pos, fr) in kept.items()}
    del scene, cams, kept, fr
    su.scene = su.cams = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    worst, bad = check_outputs(outputs, su, config, len(frame_s), device, log)
    ctx = Ctx(frame_s=frame_s, window_s=window_s, facts=facts, trace=tr, config=config,
              traffic=traffic)
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell.chips, "memory_peak_bytes": memory_peak}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
    return result(cell, ctx, traced, dev, bool(outputs), len(bad), worst,
                  config["check"]["limits"])


def log_window(frame_s, frame_end, window_s, log):
    """The window's frames/s by fifth and its frame times' quantiles."""
    fifths = np.histogram(frame_end, bins=5, range=(0.0, window_s))[0] / (window_s / 5)
    print("frames/s by fifth of the window: " + " ".join(f"{v:.2f}" for v in fifths), file=log)
    q = np.percentile(frame_s, [5, 25, 50, 75, 95, 100]) * 1e3
    print("frame ms p5 p25 p50 p75 p95 max: " + " ".join(f"{v:.3f}" for v in q), file=log)


def check_outputs(outputs, su: Setup, config, attempted, device, log):
    """Each kept frame, `outputs[view] = (window position, colour, hit)`,
    against the plain reference worked out on `device` from the run's own
    heightmap, albedo and cameras (`su`, whose facts get `check_s`);
    returns the worst reading of each number and the views whose frame
    broke a limit."""
    import torch

    from port_bench.reference.render import render as reference

    t = time.perf_counter()
    h = torch.from_numpy(su.heights_np).to(device)
    alb = None if su.albedo_np is None else torch.from_numpy(su.albedo_np).to(device)
    facts = su.facts
    check = config["check"]
    worst, bad = {k: 0 for k in check["limits"]}, set()
    for view in sorted(outputs):
        pos, color, hit = outputs[view]
        ref_color, ref_hit = reference(h, alb, su.eyes[view], su.targets[view], su.fov,
                                       config["render"], config["light"])
        nums = compare(color, hit, ref_color, ref_hit, float(check["color_tol"]))
        print(f"checked frame {pos} of {attempted} (lap view {view}): {nums}", file=log)
        if any(nums[k] > lim for k, lim in check["limits"].items()):
            bad.add(view)
        worst = {k: max(worst[k], nums[k]) for k in worst}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    facts["check_s"] = time.perf_counter() - t
    print(f"output check: {len(outputs)} frames in {facts['check_s']:.3f} s", file=log)
    return worst, bad


def result(cell: cells.Cell, ctx: Ctx, traced: bool, dev: dict, checked: bool, failed: int,
           worst: dict, limits: dict) -> dict:
    """The result line's object: the cell's end-to-end metrics (per-layer
    with `traced`) read from `ctx`, and last the numbers compared, each
    with its limit."""
    metrics = {}
    for m in cell.metrics:
        if m.per_layer == traced:
            v = m.read(ctx)
            if v is not None:
                metrics[m.name] = {"value": float(v), "unit": m.unit}
    out = {"correct": checked and failed == 0, "attempted": len(ctx.frame_s),
           "failed": failed, "metrics": metrics, "device": dev}
    if ctx.trace is not None:
        out["breakdown"] = ctx.trace.breakdown()
    out["checks"] = {k: {"value": worst[k], "limit": lim} for k, lim in limits.items()}
    return out


def trace_after_window(torch, render_one, start: int, traffic: dict, sync, cuda: bool):
    """The loop's next frames after the window, from position `start`,
    each by `render_one(position)`: first `trace_frames` without Python
    stacks, for the device's times (the stacks slow the host), then
    `named_frames` with them, to name the idle gaps. Returns the first's
    Trace with the second's gaps, the second's Trace, and the first's hit
    masks."""
    first = int(traffic["trace_frames"])
    tr, hits = _traced(torch, render_one, range(start, start + first), sync, cuda, stacks=False)
    named, _ = _traced(torch, render_one,
                       range(start + first, start + first + int(traffic["named_frames"])),
                       sync, cuda, stacks=True)
    tr.gaps = named.gaps
    return tr, named, hits


def _traced(torch, render_one, frames, sync, cuda: bool, stacks: bool):
    """Render `frames` (window positions) under torch.profiler, each by
    `render_one(position)` in the FRAME span with the port's call in
    RENDER; returns the Trace read back and the frames' hit masks."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    hits = []
    with torch.profiler.profile(activities=acts, with_stack=stacks) as prof:
        for k in frames:
            with torch.profiler.record_function(trace_mod.FRAME):
                with torch.profiler.record_function(trace_mod.RENDER):
                    f = render_one(k)
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
    if cell.chips > 1:
        from port_bench import sharded
        print(f"set-up before the ranks: interpreter and harness {t_imp - process_start():.3f} s,"
              f" torch and the port imported {imported:.3f} s", file=log)
        print(f"cards: {hostinfo.card_links()}", file=log)
        try:
            out, found = sharded.run_mesh(cell, args.seed, args.seconds, bool(args.trace), log,
                                          process_start())
        except (torch.multiprocessing.ProcessException, TimeoutError) as e:
            print(f"error: a rank failed: {e}", file=log)
            return 5
    else:
        device = torch.device("cuda", 0)
        t = time.time()
        torch.cuda.init()
        torch.empty(1, device=device)
        print(f"set-up before run_cell: interpreter and harness {t_imp - process_start():.3f} s,"
              f" torch and the port imported {imported:.3f} s, CUDA context "
              f"{time.time() - t:.3f} s", file=log)
        print(f"card: {torch.cuda.get_device_name(device)}, torch {torch.__version__}, "
              f"cuda {torch.version.cuda}", file=log)
        out, found = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, log), []
    found = sorted(set(found) | set(banned_modules()))
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
