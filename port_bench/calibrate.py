"""Readings that the output check's limits are set from, in one process.

    python3 -m port_bench.calibrate --workload B3.flyover --seeds 24 --control-seeds 3

Builds the cell's scene once, as a run's set-up does, then for each seed
renders the frames a run with that seed would check, through the port's
`render_frame` at the cell's sizes after the warm-up frames, and compares
them with the reference: the sound readings, whose largest is the lower
reading. For the first `--control-seeds` seeds it also puts the reference
computed in bfloat16 (the precision below the configuration's float32) in
the program's place: the control, whose smallest reading is the upper one.
Prints one JSON line per frame and a summary with both readings.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from port_bench import cells, paths, terrain
from port_bench.reference.render import render as reference
from port_bench.run import ROOT, compare


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=24)
    ap.add_argument("--first-seed", type=int, default=1000)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    from hmrt_tpu_torch.api.scene import make_scene
    from hmrt_tpu_torch.config import RenderConfig
    from hmrt_tpu_torch.core.renderer import render_frame
    from hmrt_tpu_torch.types import Camera, Light

    cell = cells.resolve(args.workload, ROOT / "BENCHMARK.json")
    config, traffic = cell.config, cell.traffic
    dev = torch.device("cuda", 0)
    h, alb = terrain.make_inputs(config, dev)
    hn = h.cpu().numpy()
    an = None if alb is None else alb.cpu().numpy()
    rc = RenderConfig(**config["render"])
    scene = make_scene(hn, albedo=an, light=Light.create(**config["light"], device=dev), device=dev)
    n, zmax, fov = hn.shape[0], float(hn.max()), float(traffic["fov_deg"])
    tol = float(config["check"]["color_tol"])
    warm_eyes, warm_tg, _ = paths.seeded_lap(traffic, n, zmax, 0)
    for j in range(0, len(warm_eyes), max(1, len(warm_eyes) // int(traffic["warmup_frames"]))):
        render_frame(scene, Camera.create(eye=tuple(warm_eyes[j]), target=tuple(warm_tg[j]),
                                          fov_y_deg=fov, device=dev), rc)
    torch.cuda.synchronize()
    sound, control = [], []
    for k in range(args.seeds):
        seed = args.first_seed + k
        eyes, tg, checked = paths.seeded_lap(traffic, n, zmax, seed)
        for pos in checked:
            e, g = eyes[pos % len(eyes)], tg[pos % len(tg)]
            fr = render_frame(scene, Camera.create(eye=tuple(e), target=tuple(g), fov_y_deg=fov,
                                                   device=dev), rc)
            t = time.perf_counter()
            ref = reference(h, alb, e, g, fov, config["render"], config["light"])
            ref_s = time.perf_counter() - t
            nums = compare(fr.color, fr.hit, *ref, tol)
            sound.append(nums)
            row = {"seed": seed, "frame": pos, "port": nums, "ref_s": ref_s}
            if k < args.control_seeds:
                ctl = reference(h, alb, e, g, fov, config["render"], config["light"],
                                dtype=torch.bfloat16)
                row["control"] = compare(ctl[0], ctl[1], *ref, tol)
                control.append(row["control"])
            print(json.dumps(row), flush=True)
    keys = sound[0].keys()
    summary = {"workload": args.workload, "frames": len(sound),
               "lower": {k: max(x[k] for x in sound) for k in keys},
               "upper": {k: min(x[k] for x in control) for k in keys} if control else None,
               "limits_now": config["check"]["limits"]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
