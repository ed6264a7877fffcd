"""Benchmark runner: renders the B1-B5 configs and emits metric rows in
BASELINE.json:2's schema.

Counterpart of `hmrt_tpu/bench/runner.py`. A row has the JAX row's keys
(`ROW_KEYS`), `device` (the card's name) and `strategy`: "single" for one
card, "band" for B5 rendered band-sharded over several cards
(distrib/bench.py::time_animation_sharded), "frame-dp" for an animated
config with `frame_sharded` (whole frames per rank,
time_flythrough_frames). `chips` is the number of ranks. On a machine with
k > 1 cards, B5 and `frame_sharded` start k ranks themselves (one per
card, distrib/mesh.py::spawn) and return rank 0's row; on one card B5 is
timed unsharded with the JAX runner's note, and `frame_sharded` runs on a
one-rank mesh.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time

import torch

from hmrt_tpu_torch.api.flythrough import frame_camera, orbit_flythrough
from hmrt_tpu_torch.bench.configs import BENCH_CONFIGS, bench_scene
from hmrt_tpu_torch.bench.timing import time_animation
from hmrt_tpu_torch.device import resolve
from hmrt_tpu_torch.distrib import mesh as dm
from hmrt_tpu_torch.core.renderer import choose_backend
from hmrt_tpu_torch.distrib.bench import time_animation_sharded, time_flythrough_frames
from hmrt_tpu_torch.kernels.compact import GRAPH_STEPS, frame_graphs, render_frame_compact
from hmrt_tpu_torch.types import Camera

#: the keys of every row the JAX runner writes on one device
ROW_KEYS = ("config", "description", "resolution", "map", "chips", "backend", "setup_s",
            "ms_per_frame", "fps", "mrays_per_s", "mrays_per_s_primary", "frames", "reps",
            "all_times_ms")


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


def _bench_rank(mesh, name, kw):
    """One rank of a multi-card run_bench (spawn pickles it by name)."""
    return run_bench(name, **kw, mesh=mesh)


def run_bench(name: str, frames: int | None = None, scale: float = 1.0,
              reps: int = 3, frame_sharded: bool = False, floor: bool = False,
              out_path: str | None = None, device=None, mesh=None,
              l0_tail: bool | str = "auto") -> dict:
    """Run one named benchmark config on `device` (default: the CUDA card);
    returns its metric row.

    `scale` < 1 shrinks the framebuffer (smoke runs). `frame_sharded`: for
    an animated config, render whole frames per rank (the frame count
    rounds to the ranks). `floor` adds the frame's march work and its H100
    bound (bench/floor.py), for an animated config the mean over the timed
    frames (the JAX runner counts the static bench camera's frame there).
    `out_path`: the row is written there as soon as the timing lands, and
    again after each addition to it. `mesh`: run as one rank of it (every
    rank calls run_bench; rank 0 writes the row); by default the runner
    spawns one rank per card where the config shards (module docstring).

    B5 on one rank adds the JAX runner's extras, timed by events like the
    row: `sharded_mesh1_ms` (`render_frame_sharded` on a one-rank group,
    its difference to ms_per_frame the cost of the sharding layer) and
    `band_h{H/8}_ms` (one band of H/8 rows at row0 = 4*H/8, the work of one
    card under 8-way sharding).

    `l0_tail`: the compact path's tail choice (kernels/compact.py), for a
    config that takes that path on one rank; the row says which it was. The
    default is render_frame's own ("auto")."""
    cfg = BENCH_CONFIGS[name]
    device = resolve(device) if mesh is None else mesh.device
    frame_sharded = frame_sharded and cfg.animated
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    if mesh is None and cards > 1 and (frame_sharded or cfg.sharded):
        kw = dict(frames=frames, scale=scale, reps=reps, frame_sharded=frame_sharded,
                  floor=floor, out_path=out_path)
        return dm.spawn(_bench_rank, cards, args=(name, kw), backend="nccl")
    if mesh is None and frame_sharded:
        with dm.make_mesh(device) as one:
            return run_bench(name, frames, scale, reps, frame_sharded, floor, out_path,
                             mesh=one)
    rank0 = mesh is None or mesh.rank == 0
    out_path = out_path if rank0 else None
    if l0_tail != "auto" and (mesh is not None or cfg.sharded):
        raise ValueError("l0_tail is a knob of the one-rank compact path")

    render = cfg.render
    if scale != 1.0:
        render = dataclasses.replace(
            render,
            width=max(64, int(render.width * scale) // 64 * 64),
            height=max(64, int(render.height * scale) // 64 * 64),
        )
    n_frames = frames or cfg.frames
    if frame_sharded:
        # the frame axis must divide the mesh: round the count to it
        n_frames = max(mesh.size, n_frames // mesh.size * mesh.size)

    t_setup = time.perf_counter()
    scene, cam, terr = bench_scene(cfg, device=device)
    if mesh is not None:
        scene = dm.replicate_scene(scene, mesh)
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

    chips = 1 if mesh is None else mesh.size
    compact = choose_backend(device.type, scene.m, render.backend) == "compact"
    if l0_tail != "auto" and not compact:
        raise ValueError(f"{name} does not take the compact path here: no l0_tail")

    def body(cf):
        """The loop's frame with the chosen tail (None: render_frame's own)."""
        if l0_tail == "auto":
            return None
        return lambda i: render_frame_compact(scene, frame_camera(cams, i), cf, l0_tail=l0_tail)
    graphs0 = frame_graphs.read()
    if frame_sharded:
        stats = time_flythrough_frames(scene, cams, render, n_frames, mesh, reps=reps,
                                       hit_frac=hit_frac)
        strategy = "frame-dp"
    elif cfg.sharded and chips > 1:
        stats = time_animation_sharded(scene, cams, render, n_frames, mesh, reps=reps,
                                       hit_frac=hit_frac)
        strategy = "band"
    else:
        stats = time_animation(scene, cams, render, n_frames, reps=reps, hit_frac=hit_frac,
                               render=body(render), mesh=mesh)
        strategy = "single"
    row = {
        "config": name,
        "description": cfg.description,
        "resolution": [render.width, render.height],
        "map": cfg.map_n,
        "chips": chips,
        "strategy": strategy,
        "backend": device.type,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else device.type),
        "setup_s": round(setup_s, 2),
        **{k: (round(v, 3) if isinstance(v, float) else v) for k, v in stats.items()},
    }
    if hit_frac is not None:
        row["hit_frac"] = round(hit_frac, 4)
    if compact:
        row["l0_tail"] = l0_tail
        # the timed frames through render_frame by how they ran (FrameGraphs)
        graphs = frame_graphs.read()
        row["frame_graph"] = {k: graphs[k] - graphs0[k] for k in GRAPH_STEPS}
    if cfg.sharded and chips == 1:
        row["note"] = ("UNSHARDED FALLBACK: config is multi-chip but only one "
                       "device is attached; number below is single-chip")
    _write_row(out_path, row)

    if cfg.sharded and chips == 1 and scale == 1.0:
        # the band-sharded program on one rank, and one card's band of an
        # 8-way split; a failing extra raises, as every other part of the row
        with dm.make_mesh(device) if mesh is None else contextlib.nullcontext(mesh) as one:
            row["sharded_mesh1_ms"] = round(time_animation_sharded(
                scene, cams, render, n_frames, one, reps=reps)["ms_per_frame"], 3)
        row["sharded_mesh1_note"] = (
            "render_frame_sharded on a one-rank group (band raygen, the band's "
            "render, all_gather), timed by events; its difference to ms_per_frame "
            "is the cost of the sharding layer")
        band = render.height // 8
        band_cfg = dataclasses.replace(render, height=band)
        row[f"band_h{band}_ms"] = round(time_animation(
            scene, cams, band_cfg, n_frames, reps=reps,
            render=lambda i: dm.render_band(scene, cam, band_cfg, 4 * band,
                                            render.height))["ms_per_frame"], 3)
        row[f"band_h{band}_note"] = (
            f"one {band}-row band at row0 {4 * band} of {render.height}, by the path "
            "render_frame takes: the work of one card under 8-way band sharding")
        _write_row(out_path, row)

    if name == "B4" and scale == 1.0 and device.type != "cpu" and not frame_sharded:
        # the schema (BASELINE.json:2) is defined at 1920x1080; B4's row is
        # 1280x720, so the schema-resolution number goes beside it
        render_hd = dataclasses.replace(render, width=1920, height=1080)
        stats_hd = time_animation(scene, cams, render_hd, n_frames, reps=max(1, reps - 1),
                                  hit_frac=hit_frac, render=body(render_hd))
        row["ms_per_frame_1920x1080"] = stats_hd["ms_per_frame"]
        _write_row(out_path, row)

    if floor and rank0:
        from hmrt_tpu_torch.bench.floor import floor_metrics
        row.update(floor_metrics(scene, cams if cfg.animated else cam, render,
                                 measured_ms=row["ms_per_frame"], l0_tail=l0_tail))
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
    p.add_argument("--l0-tail", choices=("auto", "true", "false"), default="auto",
                   help="the compact path's level-0 tail (kernels/compact.py)")
    p.add_argument("--frame-sharded", action="store_true",
                   help="render animated configs as whole frames per rank, one rank "
                        "per card (the multi-card B4 strategy)")
    args = p.parse_args(argv)
    from hmrt_tpu_torch.utils.profiling import maybe_trace
    for name in args.configs:
        with maybe_trace(args.profile_dir):
            row = run_bench(name, frames=args.frames, scale=args.scale, reps=args.reps,
                            frame_sharded=args.frame_sharded, floor=args.floor,
                            out_path=args.out,
                            device="cpu" if args.cpu else None,
                            l0_tail={"auto": "auto", "true": True,
                                     "false": False}[args.l0_tail])
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
