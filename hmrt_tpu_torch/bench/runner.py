"""Benchmark runner: renders the B1-B5 configs and emits metric rows in
BASELINE.json:2's schema.

Counterpart of `hmrt_tpu/bench/runner.py`, on one card. A row has the JAX
row's keys (`ROW_KEYS`); `backend` is the torch device type and `device`
the card's name. Multi-card timing (the frame-sharded B4 strategy, B5
across cards and B5's sharded extras) needs the sharding port, ROADMAP
queue 1 item 5; until then a request for it raises, and B5 on one card is
timed unsharded with the JAX runner's note.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from hmrt_tpu_torch.api.flythrough import orbit_flythrough
from hmrt_tpu_torch.bench.configs import BENCH_CONFIGS, bench_scene
from hmrt_tpu_torch.bench.timing import time_animation
from hmrt_tpu_torch.device import resolve
from hmrt_tpu_torch.types import Camera

#: the keys of every row the JAX runner writes on one device
ROW_KEYS = ("config", "description", "resolution", "map", "chips", "backend", "setup_s",
            "ms_per_frame", "fps", "mrays_per_s", "mrays_per_s_primary", "frames", "reps",
            "all_times_ms")
SHARDING = "multi-card timing needs the sharding port (ROADMAP queue 1 item 5)"


def _write_row(out_path, row):
    """Write the row to out_path atomically, so a caller's deadline never
    loses what was measured before it."""
    if not out_path:
        return
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(row, f)
    os.replace(tmp, out_path)


def _repeat(cam: Camera, n: int) -> Camera:
    """A batched Camera holding `cam` in each of n frames."""
    return Camera(**{f.name: getattr(cam, f.name).expand(n, *getattr(cam, f.name).shape)
                     for f in dataclasses.fields(cam)})


def run_bench(name: str, frames: int | None = None, scale: float = 1.0,
              reps: int = 3, frame_sharded: bool = False, floor: bool = False,
              out_path: str | None = None, device=None) -> dict:
    """Run one named benchmark config on `device` (default: the CUDA card);
    returns its metric row.

    `scale` < 1 shrinks the framebuffer (smoke runs). `floor` adds the
    frame's march work and its H100 bound (bench/floor.py), for an animated
    config the mean over the timed frames (the JAX runner counts the static
    bench camera's frame there). `out_path`: the row is written there as
    soon as the timing lands, and again after each addition to it."""
    cfg = BENCH_CONFIGS[name]
    device = resolve(device)
    if frame_sharded:
        raise NotImplementedError(f"frame_sharded: {SHARDING}")
    if cfg.sharded and device.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(f"{name} on {torch.cuda.device_count()} cards: {SHARDING}")
    render = cfg.render
    if scale != 1.0:
        render = dataclasses.replace(
            render,
            width=max(64, int(render.width * scale) // 64 * 64),
            height=max(64, int(render.height * scale) // 64 * 64),
        )
    n_frames = frames or cfg.frames

    t_setup = time.perf_counter()
    scene, cam, terr = bench_scene(cfg, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_setup

    if cfg.animated:
        cams = orbit_flythrough(cfg.map_n, float(terr.max()), n_frames, device=device)
    else:
        cams = _repeat(cam, n_frames)

    # hit fraction from one real frame: shadow rays exist only for hit
    # pixels, so this keeps Mrays/s honest on sky-heavy views
    hit_frac = None
    if render.shadows:
        from hmrt_tpu_torch.core.renderer import render_frame
        hit_frac = float(render_frame(scene, cam, render).hit.float().mean())

    stats = time_animation(scene, cams, render, n_frames, reps=reps, hit_frac=hit_frac)
    row = {
        "config": name,
        "description": cfg.description,
        "resolution": [render.width, render.height],
        "map": cfg.map_n,
        "chips": 1,
        "backend": device.type,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else device.type),
        "setup_s": round(setup_s, 2),
        **{k: (round(v, 3) if isinstance(v, float) else v) for k, v in stats.items()},
    }
    if hit_frac is not None:
        row["hit_frac"] = round(hit_frac, 4)
    if cfg.sharded:
        row["note"] = ("UNSHARDED FALLBACK: config is multi-chip but only one "
                       "device is attached; number below is single-chip")
    _write_row(out_path, row)

    if name == "B4" and scale == 1.0 and device.type != "cpu":
        # the schema (BASELINE.json:2) is defined at 1920x1080; B4's row is
        # 1280x720, so the schema-resolution number goes beside it
        render_hd = dataclasses.replace(render, width=1920, height=1080)
        stats_hd = time_animation(scene, cams, render_hd, n_frames,
                                  reps=max(1, reps - 1), hit_frac=hit_frac)
        row["ms_per_frame_1920x1080"] = stats_hd["ms_per_frame"]
        _write_row(out_path, row)

    if floor:
        from hmrt_tpu_torch.bench.floor import floor_metrics
        row.update(floor_metrics(scene, cams if cfg.animated else cam, render,
                                 measured_ms=row["ms_per_frame"]))
        _write_row(out_path, row)
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description="hmrt_tpu_torch benchmarks (B1-B5)")
    p.add_argument("configs", nargs="*", default=["B1", "B2", "B3"],
                   help="which configs to run")
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of each config here")
    p.add_argument("--out", default=None,
                   help="also write each row JSON to this file as soon as it is measured")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions) instead of the card")
    p.add_argument("--floor", action="store_true",
                   help="add the frame's march steps and its H100 bound to the row "
                        "(bench/floor.py)")
    args = p.parse_args(argv)
    from hmrt_tpu_torch.utils.profiling import maybe_trace
    for name in args.configs:
        with maybe_trace(args.profile_dir):
            row = run_bench(name, frames=args.frames, scale=args.scale, reps=args.reps,
                            floor=args.floor, out_path=args.out,
                            device="cpu" if args.cpu else None)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
