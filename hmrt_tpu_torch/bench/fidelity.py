"""What the relaxed tail costs in fidelity, and what it buys in time.

Counterpart of `tools/fidelity_relaxed.py` of the JAX package: it renders
one frame through the compact path with the exact level-0 tail
(`render_frame_compact(l0_tail=True)`) and with the relaxed tail at each
stride (`relax=k`), and reports for each stride, against the exact frame:

    ms_per_frame        median of `reps` frames by CUDA events (None on the CPU)
    speedup_vs_exact    the exact tail's ms over this one's
    false_hits          relaxed hits where the exact frame has none (the contract: 0)
    missed_hits         exact hits the relaxed frame lost (tunnelled)
    late_hits           common hits more than 1e-3 deeper than the exact hit
    hit_mismatch_frac   (missed + false + late) over the exact hits
    t_err_max, t_err_p99  |t relaxed - t exact| over the common hits
    psnr_db             colour PSNR against the exact frame

Every frame renders the same camera: CUDA neither deduplicates work nor
reports it done early, so the JAX tool's camera salt has no use here.

    python -m hmrt_tpu_torch.bench.fidelity B3 [--strides 4,8,16] [--reps 3]
    python -m hmrt_tpu_torch.bench.fidelity B4 --cpu --scale 0.0625 --map 257

B4 renders its orbit's frame 0; the others their static bench camera.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math

import torch

from hmrt_tpu_torch.config import RenderConfig
from hmrt_tpu_torch.kernels.compact import render_frame_compact
from hmrt_tpu_torch.types import Camera, Scene

LATE_T = 1e-3  # a common hit this much deeper than the exact one counts as late


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    """PSNR in dB of two colour buffers in [0, 1]; inf when equal."""
    mse = float(((a.double() - b.double()) ** 2).mean())
    return math.inf if mse == 0 else 10.0 * math.log10(1.0 / mse)


def frame_ms(render, device: torch.device, reps: int):
    """Median ms of `reps` calls of render() by CUDA events after one warm
    call; None off the card (a host clock is no device time)."""
    render()
    if device.type != "cuda":
        return None
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        render()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def compare(exact, relaxed) -> dict:
    """The fidelity numbers of a relaxed frame against the exact one (both
    with aux buffers)."""
    eh, rh = exact.hit, relaxed.hit
    both = eh & rh
    dt = (relaxed.depth[both] - exact.depth[both]).abs().double()
    late = both & ((relaxed.depth - exact.depth).abs() > LATE_T)
    mism = (rh != eh) | late
    return {
        "false_hits": int((rh & ~eh).sum()),
        "missed_hits": int((eh & ~rh).sum()),
        "late_hits": int(late.sum()),
        "hit_mismatch_frac": int(mism.sum()) / max(int(eh.sum()), 1),
        "t_err_max": float(dt.max()) if dt.numel() else 0.0,
        "t_err_p99": float(torch.quantile(dt, 0.99)) if dt.numel() else 0.0,
        "psnr_db": psnr(relaxed.color, exact.color),
    }


def fidelity(scene: Scene, camera: Camera, config: RenderConfig,
             strides=(4, 8, 16), reps: int = 3) -> dict:
    """The exact tail's ms and hits, and one row (module docstring) per
    stride in `strides`."""
    aux = dataclasses.replace(config, aux_buffers=True)
    dev = scene.device

    def render(relax, cfg=config):
        return render_frame_compact(scene, camera, cfg, l0_tail=True, relax=relax)

    ms_exact = frame_ms(lambda: render(0), dev, reps)
    exact = render(0, aux)
    rows = []
    for k in strides:
        ms = frame_ms(lambda: render(k), dev, reps)
        rows.append({"stride": k, "ms_per_frame": ms,
                     "speedup_vs_exact": (ms_exact / ms if ms else None),
                     **compare(exact, render(k, aux))})
    return {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
            "exact_ms_per_frame": ms_exact, "exact_hits": int(exact.hit.sum()),
            "pixels": config.width * config.height, "rows": rows}


def main(argv=None):
    from hmrt_tpu_torch.api.flythrough import frame_camera, orbit_flythrough
    from hmrt_tpu_torch.bench.configs import BENCH_CONFIGS, bench_scene
    p = argparse.ArgumentParser(description="relaxed tail fidelity against the exact tail")
    p.add_argument("config", choices=sorted(BENCH_CONFIGS))
    p.add_argument("--strides", default="4,8,16")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--scale", type=float, default=1.0, help="frame size factor (smoke runs)")
    p.add_argument("--map", type=int, default=None, help="map size instead of the config's")
    p.add_argument("--cpu", action="store_true", help="run the plain versions on the CPU")
    args = p.parse_args(argv)
    cfg = BENCH_CONFIGS[args.config]
    if args.map:
        cfg = dataclasses.replace(cfg, map_n=args.map)
    render = dataclasses.replace(cfg.render,
                                 width=max(16, int(cfg.render.width * args.scale)),
                                 height=max(16, int(cfg.render.height * args.scale)))
    dev = "cpu" if args.cpu else None
    scene, cam, terr = bench_scene(cfg, device=dev)
    if cfg.animated:
        cam = frame_camera(orbit_flythrough(cfg.map_n, float(terr.max()), cfg.frames,
                                            device=scene.device), 0)
    out = fidelity(scene, cam, render, tuple(int(s) for s in args.strides.split(",")),
                   args.reps)
    print(json.dumps({"config": args.config, "map": cfg.map_n,
                      "resolution": [render.width, render.height], **out}), flush=True)


if __name__ == "__main__":
    main()
