#!/usr/bin/env python3
"""Smoke test of the hmrt_tpu_torch port on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the package's CUDA kernels from the sources in the checkout,
renders B3 (a 4096^2 DEM at 1920x1080 with Phong, shadows and the sky
early-out) through the normal entry points and times it, holds each kernel
against its plain torch version at the shapes of that main path, and holds
rendered frames against the torch oracle. It prints the card's name and
power limit, one JSON line of per-kernel results, and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero;
without a CUDA device it exits 1 before doing anything.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_SAMPLE = 65536   # rays per kernel-vs-plain march comparison
STATE = ("alive", "t", "lvl", "icx", "icy")
RESULTS = ("hit", "t_hit", "hx", "hy")


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def event_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` calls, by CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare_march(label, rays, state, scene, budgets):
    """march_pass kernel vs march_pass_reference from the same state, for
    each budget: state planes equal on the lanes alive at the start, the
    alive plane and the results equal everywhere. Returns the largest
    absolute difference over all planes (0.0 when exact)."""
    import torch
    from hmrt_tpu_torch.kernels.march_pass import march_pass, march_pass_reference
    from hmrt_tpu_torch.traversal.intersect import BIG_T
    p = rays[0].shape[0]
    dev = rays[0].device
    res = (torch.zeros(p, dtype=torch.int32, device=dev),
           torch.full((p,), BIG_T, device=dev),
           torch.zeros(p, dtype=torch.int32, device=dev),
           torch.zeros(p, dtype=torch.int32, device=dev))
    kw = dict(n=scene.n, m=scene.m, levels=scene.levels)
    worst = 0.0
    alive_in = state[0] != 0
    for b in budgets:
        sk, rk = march_pass(rays, state, res, scene.pyr_flat, scene.heights, budget=b, **kw)
        torch.cuda.synchronize()
        sr, rr = march_pass_reference(rays, state, res, scene.pyr_flat, scene.heights,
                                      budget=b, **kw)
        for name, a, c in zip(STATE + RESULTS, sk + rk, sr + rr):
            sel = alive_in if name in STATE[1:] else slice(None)
            if not torch.equal(a[sel], c[sel]):
                bad = int((a[sel] != c[sel]).sum())
                raise AssertionError(f"march_pass {label} budget {b}: plane {name} "
                                     f"differs on {bad} lanes")
            worst = max(worst, float((a[sel].double() - c[sel].double()).abs().max()))
        log(f"  march_pass {label} budget {b}: 9 planes equal; "
            f"{int(alive_in.sum())} rays alive in, {int(sk[0].sum())} alive out, "
            f"{int(rk[0].sum())} hits")
    return worst, res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    log(card)
    sys.path.insert(0, str(ROOT))
    import hmrt_tpu_torch as T
    if not Path(T.__file__).resolve().is_relative_to(ROOT):
        raise RuntimeError(f"hmrt_tpu_torch imported from {T.__file__}, not this checkout")
    from hmrt_tpu_torch.bench.configs import BENCH_CONFIGS, bench_scene
    from hmrt_tpu_torch.core.renderer import render_frame_oracle
    from hmrt_tpu_torch.kernels import _build
    from hmrt_tpu_torch.kernels.compact import (FIRST_BUDGET, ROUND_BUDGET, ROUNDS,
                                                hit_points, init_state, march_rounds,
                                                primary_rays, shadow_start)
    from hmrt_tpu_torch.kernels.march_pass import (UNBUDGETED, march_pass,
                                                   march_pass_reference)
    from hmrt_tpu_torch.kernels.shade_pass import shade_pass, shade_pass_reference

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {kind}")

    # ---- 1. build the kernels from the checkout's sources ----------------
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for line in sorted(_build.BUILD_DIR.glob("*.log"))[-1].read_text().splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    # ---- 2. the main path: B3 through render_frame -----------------------
    b3 = BENCH_CONFIGS["B3"]
    cfg = b3.render
    t0 = time.perf_counter()
    scene, cam, _ = bench_scene(b3, device=dev)
    torch.cuda.synchronize()
    log(f"B3 scene: {scene.n}^2 samples, m={scene.m}, {scene.levels} levels, "
        f"built in {time.perf_counter() - t0:.2f} s")

    march_pass.launches = 0
    shade_pass.launches = 0
    fr = T.render_frame(scene, cam, cfg)
    torch.cuda.synchronize()
    launches = {"march_pass": march_pass.launches, "shade_pass": shade_pass.launches}
    log(f"B3 main path launches: {launches}")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"{k} was not launched by render_frame")
    color = fr.color
    if color.shape != (cfg.height, cfg.width, 3) or fr.hit.shape != (cfg.height, cfg.width):
        raise AssertionError(f"B3 frame has shape {tuple(color.shape)}")
    if not bool(torch.isfinite(color).all()) or float(color.min()) < 0 or float(color.max()) > 1:
        raise AssertionError("B3 colours are not finite values in [0, 1]")
    hit_frac = float(fr.hit.float().mean())
    if not 0.05 < hit_frac < 0.95:
        raise AssertionError(f"B3 hit fraction {hit_frac} outside (0.05, 0.95)")
    log(f"B3 frame: {cfg.width}x{cfg.height}, hit fraction {hit_frac:.4f}, colours in "
        f"[{float(color.min()):.4f}, {float(color.max()):.4f}]")

    times = []
    for _ in range(5):
        times.append(event_ms(lambda: T.render_frame(scene, cam, cfg), 1))
    times.sort()
    ms = times[len(times) // 2]
    primary = cfg.width * cfg.height
    log(f"B3 warm frames (ms, CUDA events): {times}")
    log(f"B3: {ms:.3f} ms/frame (median of 5), "
        f"{primary * (1 + hit_frac) / ms / 1e3:.2f} Mrays/s with shadow rays, "
        f"{primary / ms / 1e3:.2f} Mrays/s primary  [{card}]")

    # ---- 3. kernels vs plain versions at the main path's shapes ----------
    rays = primary_rays(cam, cfg)
    p = rays[0].shape[0]
    idx = torch.arange(N_SAMPLE, device=dev) * (p // N_SAMPLE)
    srays_p = tuple(r.index_select(0, idx).contiguous() for r in rays)
    st0 = init_state(srays_p, None, scene.pyr_flat[-1], n=scene.n, m=scene.m,
                     levels=scene.levels)
    budgets = (1, 7, 64, UNBUDGETED)
    err_primary, res0 = compare_march("primary", srays_p, st0, scene, budgets)
    # from a mid-march state as well: the kernel's own state after 64 steps
    mid = march_pass(srays_p, st0, res0, scene.pyr_flat, scene.heights, n=scene.n,
                     m=scene.m, levels=scene.levels, budget=64)[0]
    err_mid, _ = compare_march("primary, from step 64", srays_p, mid, scene, (7, UNBUDGETED))

    args = (srays_p, st0, res0, scene.pyr_flat, scene.heights)
    kw = dict(n=scene.n, m=scene.m, levels=scene.levels, budget=UNBUDGETED)
    march_pass(*args, **kw)
    march_ms = event_ms(lambda: march_pass(*args, **kw), 10)
    march_plain_ms = event_ms(lambda: march_pass_reference(*args, **kw), 1)
    log(f"march_pass, {N_SAMPLE} B3 primary rays unbudgeted: kernel {march_ms:.3f} ms, "
        f"plain {march_plain_ms:.3f} ms  [{card}]")

    # full-frame primary march (kernel), then the shade pass on every lane
    st_full = init_state(rays, None, scene.pyr_flat[-1], n=scene.n, m=scene.m,
                         levels=scene.levels)
    hit_i, t_hit, hx, hy = march_rounds(rays, st_full, scene, cell_intersect=cfg.cell_intersect,
                                        clip=None, first_budget=FIRST_BUDGET, rounds=ROUNDS,
                                        round_budget=ROUND_BUDGET, moving=(3, 4, 5))
    hit = hit_i != 0
    if not torch.equal(hit.reshape(fr.hit.shape), fr.hit):
        raise AssertionError("primary march of the B3 frame is not reproducible")
    points, fx, fy = hit_points(rays, hit, t_hit, hx, hy)
    shade_args = (hit_i, hx, hy, fx, fy, scene.gx, scene.gy, None)
    got = shade_pass(*shade_args)
    torch.cuda.synchronize()
    want = shade_pass_reference(*shade_args)
    err_shade = max(float((a - b).abs().max()) for a, b in zip(got, want))
    if err_shade > 1e-6:
        raise AssertionError(f"shade_pass differs from its plain version by {err_shade}")
    log(f"  shade_pass on all {p} lanes ({int(hit.sum())} hits): max |kernel - plain| "
        f"{err_shade:.3g} (bar 1e-6)")
    shade_ms = event_ms(lambda: shade_pass(*shade_args), 20)
    shade_plain_ms = event_ms(lambda: shade_pass_reference(*shade_args), 5)
    log(f"shade_pass, {p} B3 lanes: kernel {shade_ms:.4f} ms, plain {shade_plain_ms:.4f} ms"
        f"  [{card}]")

    # shadow rays from the frame's hits, started in the hit cells
    srays, sstate = shadow_start(points, got[:3], hit, hx, hy, scene)
    hit_lanes = torch.nonzero(hit).squeeze(1)
    pick = hit_lanes[torch.linspace(0, hit_lanes.shape[0] - 1, min(N_SAMPLE, hit_lanes.shape[0]),
                                    device=dev).long()]
    sh_rays = tuple(r.index_select(0, pick).contiguous() for r in srays)
    sh_state = tuple(s.index_select(0, pick).contiguous() for s in sstate)
    err_shadow, res_sh = compare_march("shadow", sh_rays, sh_state, scene, budgets)
    shadow_ms = event_ms(lambda: march_pass(sh_rays, sh_state, res_sh, scene.pyr_flat,
                                            scene.heights, **kw), 10)
    log(f"march_pass, {sh_rays[0].shape[0]} B3 shadow rays unbudgeted: kernel "
        f"{shadow_ms:.3f} ms  [{card}]")
    torch.cuda.synchronize()

    # ---- 4. frames vs the torch oracle on the card -----------------------
    def check_vs_oracle(label, sc, cm, cf):
        fc = T.render_frame(sc, cm, cf)
        t1 = time.perf_counter()
        fo = render_frame_oracle(sc, cm, cf)
        torch.cuda.synchronize()
        t_oracle = time.perf_counter() - t1
        if not torch.equal(fc.hit, fo.hit):
            raise AssertionError(f"{label}: hit mask differs on "
                                 f"{int((fc.hit != fo.hit).sum())} pixels")
        dc = float((fc.color - fo.color).abs().max())
        if dc >= 5e-5:
            raise AssertionError(f"{label}: colour differs by {dc}")
        msg = f"{label} vs torch oracle: hit mask equal, max colour diff {dc:.3g}"
        if cf.aux_buffers:
            h = fo.hit
            dd = (fc.depth[h] - fo.depth[h]).abs()
            if bool((dd > 1e-4 + 1e-5 * fo.depth[h].abs()).any()):
                raise AssertionError(f"{label}: depth differs by {float(dd.max())}")
            dn = float((fc.normal[h] - fo.normal[h]).abs().max())
            if dn > 1e-4:
                raise AssertionError(f"{label}: normal differs by {dn}")
            msg += f", depth {float(dd.max()):.3g}, normal {dn:.3g}"
        log(msg + f" (oracle took {t_oracle:.1f} s)")

    b2 = BENCH_CONFIGS["B2"]
    scene2, cam2, _ = bench_scene(b2, device=dev)
    check_vs_oracle("B2-class 1024^2 1024x768 aux", scene2, cam2, b2.render)
    check_vs_oracle("B3 4096^2 1920x1080 phong+shadows", scene, cam, cfg)

    kernels = [
        {"name": "march_pass", "route": "cuda",
         "source": "hmrt_tpu_torch/kernels/csrc/march_pass.cu",
         "replaces": "hmrt_tpu/kernels/compact.py:80",
         "launches": launches["march_pass"],
         "max_abs_err": max(err_primary, err_mid, err_shadow),
         "ms": march_ms, "plain_ms": march_plain_ms},
        {"name": "shade_pass", "route": "cuda",
         "source": "hmrt_tpu_torch/kernels/csrc/shade_pass.cu",
         "replaces": "hmrt_tpu/kernels/compact.py:562",
         "launches": launches["shade_pass"],
         "max_abs_err": err_shade, "ms": shade_ms, "plain_ms": shade_plain_ms},
    ]
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
