#!/usr/bin/env python3
"""Smoke test of the hmrt_tpu_torch port on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the package's CUDA kernels and its host library (g++) from the
sources in the checkout and drives both render paths through the normal
entry points:

  - the host library: B3's 4096^2 fBm terrain and a 2049^2 16-bit PNG whose
    rows cycle through the five filters, each against its numpy or Python
    spec, bit for bit, both timed;
  - the compact path: B3 (a 4096^2 DEM at 1920x1080 with Phong, shadows
    and the sky early-out) under backend "auto", timed; march_pass and
    shade_pass held against their plain versions at its shapes, march_pass
    also on 1, 33 and 300,000 rays and at a budget that ends rays inside a
    chunk; B2 and B3 frames against the torch oracle;
  - the fused path: B1 (256^2, 512x512, Lambert) under "auto", which takes
    the fused kernel, against the torch oracle; B3 through backend
    "pallas", timed and held against the compact frame; the fused kernel
    against its plain version on the B1 frame and on a 16-row band of B3
    at the horizon; B1's counter planes through render_frame with
    debug_counters; B2 under both backends;
  - raygen's tan(fov/2) bits for 55 and 60 degrees, and B3's ray
    directions, equal on the card and the CPU, the pixels of B3 and B4
    that raygen's correctly rounded norm moves against torch's f32 sqrt
    on the card, and the hostile camera under the terrain hitting the CPU
    oracle's pixels on the card;
  - the four hostile cameras of tests/test_sanitizers.py through the
    compact and fused kernels against their plain versions and the oracle,
    then again in a subprocess (`--hostile`) under compute-sanitizer's
    memcheck; the card's compact and fused renders against the B4-class
    golden tests/golden/b4_64.npy;
  - the kernels' counting instances: per-ray steps and cell tests equal to
    the plain version's counts, the full B3 frame's work and from it each
    kernel's bound on that frame, and the warp efficiency of one thread per
    ray without refill;
  - where the time goes: the device time of each launch of one compact B3
    frame, B3 compact and fused timed in turns, and profiles of a frame of
    each path;
  - the animation path: B4 (an 8192^2 map with albedo texture, fog and
    Phong at 1280x720) along its scripted orbit through render_frame
    (compact: march_pass and the textured shade_pass), frames against the
    torch oracle, march_pass against its plain version on a sample of the
    frame's rays that holds its longest ones, the textured shade_pass
    against its plain version on every lane (with the 32-byte sectors per
    hit that its records and the old planes cost, modelled from the hit
    cells), the frame's march work and bound, a profile;
  - the bench runner (bench/runner.py) for B1-B5, one JSON row each;
  - the out-of-core tiled renderer: B4 in 2048-cell tiles and B3 with
    shadows (the shadow sweep on march_pass), each against the resident
    frame, every pixel outside the bars traced to the f32 cell test; and
    march_pass against its plain version on a B4 tile's sub-scene under
    its clip window;
  - sharding (phase 14): B5's 8 bands of 270 rows through compact, B1's 8
    bands of 64 rows and B3's 2 bands of 540 through the fused kernel,
    stacked, against the one-card frames (hit, depth and hit cells equal);
    render_frame_sharded of B5 on a one-rank NCCL group against
    render_frame, both timed; two gloo ranks sharing the card (B5
    band-sharded, B4's first 2 orbit frames frame-sharded, the scene
    replicated from rank 0); B5 over every card where there are several;
    the runner's frame-parallel B4 row;
  - the entry points (phase 15): the render CLI as four subprocesses at
    once (plain with --shadows --aux, --sharded, --tile on a .r32 file,
    --flythrough), the viewer CLI's HTML and APNG, the HTTP viewer server
    in a thread on 127.0.0.1 (GET /, /state, POST /frame draft and full,
    a non-finite camera), each against render_frame at that camera; and
    load_heightmap on a PNG, a PGM, a TIFF and an ESRI ASCII grid;
  - the grazing tail (phase 16): march_pass's level-0 tail at one lane and
    32 lanes a ray on ~8,192 of B3's tail rays and on B4's 16, and its
    relaxed tail at strides 4, 8 and 16 on B3's, against their plain
    versions (all 9 planes and the per-ray counts exact; the level-0
    tail's hits also against the old walk, every cell tested, with its
    steps beside the new), timed beside their plain versions and bounds,
    with the warp efficiency of B3's tail at one lane a ray (B4's main path
    must have taken the march of one lane a ray, phase 11); B3's primary and shadow
    tail launches and B4's as the main path makes them, at their full
    width, replayed with every lane group against the plain version of the
    march each ran on their live lanes and against the old walk's hits;
    the min pyramid's MB; B4's latency bound, the least of the two
    marches' chains of dependent steps at the time of one step of the probe
    bench/latency.py (one dependent record load and cell test); the relaxed tail's fidelity and
    time on full B3 and B4 frames (bench/fidelity.py: no false hit
    anywhere, B3's mismatch at most 1e-3); the longest per-ray step chain of the tail
    launch on B3 and B4 with each tail; the runner's B2, B3 and B4 rows with
    l0_tail False and "auto".

`python3 chip_smoke.py --cards`, on a machine with several cards, runs only
B5 band-sharded over every card against one card (phase 14(d));
`--hostile` runs only the hostile cameras through the kernels.

It prints the card's name and power limit, one JSON line of per-kernel
results (time, plain time, launches, error and the bound of each), and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero;
without a CUDA device it exits 1 before doing anything.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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


def corner_samples(hit, hx, hy, n: int) -> int:
    """Distinct grid samples at the 4 corners of the hit cells."""
    import torch
    base = (torch.clamp(hy, 0, n - 2) * n + torch.clamp(hx, 0, n - 2))[hit]
    return int(torch.unique(torch.cat([base + o for o in (0, 1, n, n + 1)])).numel())


def shade_sectors(hit, hx, hy, n: int, textured: bool) -> dict:
    """The 32-byte sectors the shade pass's gathers touch, modelled from the
    hit cells, per hit and distinct over all hits, in two layouts:
    "planes", 4-byte loads at the cell's 4 corners on rows cy and cy+1 of
    gx, gy (and the 3 planar albedo channels), each plane (N, N) from a
    sector boundary; "records", the cell's 32-byte shade record (and
    48-byte albedo record) from a sector boundary, C = N-1 cells a side."""
    import torch
    c = n - 1
    cx = torch.clamp(hx[hit], 0, c - 1).long()
    cy = torch.clamp(hy[hit], 0, c - 1).long()
    hits = max(int(cx.numel()), 1)
    # one plane: rows cy and cy+1, two 4-byte corners each; every plane the same
    b = cy * n + cx
    rows = [((b + r) * 4 // 32, (b + r + 1) * 4 // 32) for r in (0, n)]
    p_hit = sum(int((lo != hi).sum()) + lo.numel() for lo, hi in rows)
    p_distinct = int(torch.unique(torch.cat([x for pair in rows for x in pair])).numel())
    planes = 2 + 3 * textured
    # the records: [first, last] sector of each
    cell = cy * c + cx
    spans = [(cell, cell)] + ([(cell * 48 // 32, (cell * 48 + 47) // 32)] if textured else [])
    r_hit = sum(int((hi - lo + 1).sum()) for lo, hi in spans)
    r_distinct = sum(int(torch.unique(torch.cat([lo, hi])).numel()) for lo, hi in spans)
    return {"planes": {"sectors_per_hit": planes * p_hit / hits,
                       "distinct_mb": planes * p_distinct * 32 / 1e6},
            "records": {"sectors_per_hit": r_hit / hits, "distinct_mb": r_distinct * 32 / 1e6}}


PAD_S = 0.25        # idle host time at each end of a profiled window
SPIN_CYCLES = 2e8   # ~0.1 s of spin kernel: the host queues the timed calls meanwhile


def profiled(fn, calls: int, cuda_only: bool = True, counted=None):
    """torch.profiler over `calls` calls of fn(), after one warm call, and
    the launches that the wrapper `counted` made in those calls. The calls
    sit between PAD_S of idle host time on each side: on the H100 machine a
    window of a few ms late in a long run lost device events (of 20
    launches of a ~40 us kernel, some in one call and none in the next), and
    a wider window keeps them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    n0 = counted.launches if counted is not None else 0
    acts = [ProfilerActivity.CUDA] + ([] if cuda_only else [ProfilerActivity.CPU])
    with profile(activities=acts) as prof:
        time.sleep(PAD_S)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(PAD_S)
    return prof, (counted.launches - n0 if counted is not None else None)


def kernel_wrapper(kernel: str):
    """The port's wrapper that launches (and counts) the CUDA kernel `kernel`."""
    from hmrt_tpu_torch.bench.latency import l0_walk
    from hmrt_tpu_torch.kernels.march_pass import march_pass
    from hmrt_tpu_torch.kernels.raycast import render_frame_fused
    from hmrt_tpu_torch.kernels.shade_pass import shade_pass
    return {"march_pass_kernel": march_pass, "shade_pass_kernel": shade_pass,
            "render_tile_kernel": render_frame_fused, "l0_probe_kernel": l0_walk}[kernel]


def queued_ms(fn, reps: int) -> float:
    """Device time per call of fn() by CUDA events, the calls queued behind
    a spin kernel so that the host's work between launches stays off the
    card's clock (unless fn() itself waits for the card)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(SPIN_CYCLES))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, kernel: str, reps: int) -> float:
    """Device time per call of the CUDA kernel whose name contains
    `kernel`, over `reps` calls of fn(): from torch.profiler when it
    recorded every launch that the kernel's wrapper counted, the kernel
    alone without the wrapper's host work between launches. Otherwise it
    says so and times the calls by `queued_ms`, which also holds fn()'s
    other device work."""
    from torch.autograd import DeviceType
    prof, launched = profiled(fn, reps, counted=kernel_wrapper(kernel))
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and kernel in e.name]
    if launched > 0 and len(us) == launched:
        return sum(us) / 1e3 / reps
    ms = queued_ms(fn, reps)
    log(f"  the profiler recorded {len(us)} of {launched} launches of {kernel}: "
        f"{ms:.4f} ms per call by events, queued behind a spin kernel")
    return ms


def launch_times(fn, names, frames: int = 3) -> list:
    """[(kernel name, device ms), ...] of each launch, in launch order, of
    the kernels whose names contain one of `names`, in one call of fn(): the
    mean over `frames` calls, from torch.profiler's device events."""
    from torch.autograd import DeviceType
    prof, _ = profiled(fn, frames)
    evs = sorted((e.time_range.start, name, e.time_range.elapsed_us() / 1e3)
                 for e in prof.events() if e.device_type == DeviceType.CUDA
                 for name in names if name in e.name)
    if not evs or len(evs) % frames:
        raise RuntimeError(f"the profiler recorded {len(evs)} launches of {names} "
                           f"in {frames} calls")
    k = len(evs) // frames
    return [(evs[i][1], sum(evs[f * k + i][2] for f in range(frames)) / frames)
            for i in range(k)]


def warp_efficiency(steps, groups) -> float:
    """Steps over the lane-steps that one thread per ray spends when a warp
    lasts as long as its longest ray: sum(steps) / (32 x sum over warps of
    the warp's longest ray). `steps` is a list of per-ray step tensors, each
    cut into warps by `groups` (a function from it to a (warps, 32) or
    (warps, 32, k) tensor whose k columns are marches the old kernel ran one
    after the other)."""
    import torch
    total = lanes = 0
    for st in steps:
        total += int(st.sum(dtype=torch.int64))
        lanes += 32 * int(groups(st).amax(dim=1).sum(dtype=torch.int64))
    return total / lanes


def median_ms(fn, reps: int) -> tuple[float, list]:
    """Median over `reps` single calls of fn(), each timed by CUDA events."""
    times = sorted(event_ms(fn, 1) for _ in range(reps))
    return times[len(times) // 2], times


def profile_frames(label, fn, frame_ms, frames: int = 3):
    """torch.profiler over `frames` calls of fn(): device time per frame by
    kernel, and the busy share of `frame_ms` (the frame's time by events)."""
    prof, _ = profiled(fn, frames, cuda_only=False)
    rows = [(e.key, getattr(e, "self_device_time_total", 0) / 1e3 / frames)
            for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy = sum(t for _, t in rows)
    if not rows:
        log(f"{label}: the profiler recorded no device time")
        return
    log(f"{label}: device busy {busy:.3f} ms per frame of {frame_ms:.3f} ms "
        f"({100 * busy / frame_ms:.1f}%, idle {100 * (1 - busy / frame_ms):.1f}%); by kernel:")
    for key, t in rows[:8]:
        log(f"    {t:9.4f} ms  {key[:90]}")


def compare_march(label, rays, state, scene, budgets, counter=None, clip=None):
    """march_pass kernel vs march_pass_reference from the same state, for
    each budget: state planes equal on the lanes alive at the start, the
    alive plane and the results equal everywhere. `counter` records the
    work of the unbudgeted plain run; `clip` is the cell window of both.
    Returns the largest absolute difference over all planes (0.0 when
    exact) and the empty result planes both started from."""
    import torch
    from hmrt_tpu_torch.kernels.march_pass import (UNBUDGETED, march_pass,
                                                   march_pass_reference)
    from hmrt_tpu_torch.traversal.intersect import BIG_T
    p = rays[0].shape[0]
    dev = rays[0].device
    res = (torch.zeros(p, dtype=torch.int32, device=dev),
           torch.full((p,), BIG_T, device=dev),
           torch.zeros(p, dtype=torch.int32, device=dev),
           torch.zeros(p, dtype=torch.int32, device=dev))
    kw = dict(n=scene.n, m=scene.m, levels=scene.levels, clip=clip)
    worst = 0.0
    alive_in = state[0] != 0
    for b in budgets:
        sk, rk = march_pass(rays, state, res, scene.pyr_flat, scene.heights, scene.corners,
                            budget=b, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sr, rr = march_pass_reference(rays, state, res, scene.pyr_flat, scene.heights,
                                      budget=b, **kw,
                                      counter=counter if b == UNBUDGETED else None)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        for name, a, c in zip(STATE + RESULTS, sk + rk, sr + rr):
            sel = alive_in if name in STATE[1:] else slice(None)
            if not torch.equal(a[sel], c[sel]):
                bad = int((a[sel] != c[sel]).sum())
                raise AssertionError(f"march_pass {label} budget {b}: plane {name} "
                                     f"differs on {bad} lanes")
            if a[sel].numel():
                worst = max(worst, float((a[sel].double() - c[sel].double()).abs().max()))
        log(f"  march_pass {label} budget {b}: 9 planes equal; "
            f"{int(alive_in.sum())} rays alive in, {int(sk[0].sum())} alive out, "
            f"{int(rk[0].sum())} hits (plain version {plain_s:.1f} s)")
    return worst, res

TILE = 2048  # cells per tile edge in the tiled phase


def tile_rays(rays, x0, y0):
    """Ray planes moved into the frame of the tile at (y0, x0): its
    sub-scene starts one margin sample before the tile, an exact shift."""
    return (rays[0] - (x0 - 1), rays[1] - (y0 - 1)) + tuple(rays[2:])


def march_to_end(rays, scene, clip=None):
    """The kernel's march of `rays` on `scene` to the end, from the pyramid
    top: (hit bool, t, hx, hy)."""
    from hmrt_tpu_torch.kernels.compact import empty_results, init_state
    from hmrt_tpu_torch.kernels.march_pass import UNBUDGETED, march_pass
    state = init_state(rays, None, scene.pyr_flat[-1], n=scene.n, m=scene.m,
                       levels=scene.levels, clip=clip)
    hit, t, hx, hy = march_pass(rays, state, empty_results(rays[0].shape[0], rays[0].device),
                                scene.pyr_flat, scene.heights, scene.corners, n=scene.n,
                                m=scene.m, levels=scene.levels, budget=UNBUDGETED, clip=clip)[1]
    return hit != 0, t, hx, hy


def cell_triangles(rays, cx, cy, heights):
    """The exact test of cell (cx, cy) per ray, step by step as
    `intersect_triangles` (traversal/intersect.py) takes it in f32, for its
    two triangles: the plane crossings t, whether each crossing lies inside
    its triangle, the least slack of its three containment tests in float64
    (negative: outside) and the crossing's larger |x|, |y|; each (2, P).
    Also the test's own verdict with the window [0, BIG_T]; the replica
    must agree with it."""
    import numpy as np
    import torch
    from hmrt_tpu_torch.traversal.intersect import BIG_T, _safe, intersect_triangles
    ox, oy, oz, dx, dy, dz = rays
    n = heights.shape[1]
    hf = heights.reshape(-1)
    base = cy.long() * n + cx.long()
    z = tuple(hf[base + o] for o in (0, 1, n, n + 1))
    z00, z10, z01, z11 = z
    fx, fy = cx.to(torch.float32), cy.to(torch.float32)
    lo, hi, lo2 = (float(np.float32(v)) for v in (-1e-6, 1.0 + 1e-6, 1.0 - 1e-6))
    ts, inside, slack, mag = [], [], [], []
    for k, (a, gx, gy) in enumerate(((z00, z10 - z00, z01 - z00),
                                     (z10 - z11 + z01, z11 - z01, z11 - z10))):
        t = (a + gx * (ox - fx) + gy * (oy - fy) - oz) / _safe(dz - gx * dx - gy * dy)
        px, py = ox + t * dx, oy + t * dy
        u, v = (px - fx).double(), (py - fy).double()
        w = (px - fx + (py - fy)).double()
        sl = (torch.stack([u - lo, v - lo, hi - w]) if k == 0
              else torch.stack([hi - u, hi - v, w - lo2])).amin(0)
        ts.append(t)
        inside.append(sl >= 0)
        slack.append(sl)
        mag.append(torch.maximum(px.abs(), py.abs()).double())
    ts, inside = torch.stack(ts), torch.stack(inside)
    verdict = intersect_triangles(ox, oy, oz, dx, dy, dz, cx, cy, *z,
                                  torch.zeros_like(ox), torch.full_like(ox, BIG_T))[0]
    if not torch.equal(verdict, (inside & (ts >= 0) & (ts <= BIG_T)).any(0)):
        raise AssertionError("the replica of the exact cell test disagrees with it")
    return ts, inside, torch.stack(slack), torch.stack(mag), verdict


def ulp32(x):
    """The spacing of f32 numbers at magnitude x (float64 tensor)."""
    import torch
    return torch.exp2(torch.floor(torch.log2(torch.clamp_min(x, 1.0))) - 23)


def check_tiled(label, sc, cm, cf, source, cap, run_path, paths, card, **kw):
    """The tiled frame (tiles of TILE cells) against the resident one, with
    the JAX package's tiled bars: hit equal, depth within 1e-4 relative,
    colour within 2e-4. Also: the march_pass launches of the tile renders
    (3 each) and of the shadow sweep (2 per tile marched), one shade_pass
    per tile render; culling changes no hit or depth.

    The exact cell test rounds in f32 at the magnitude of the coordinates
    it is given, and the tiles move the camera by an exact integer offset
    (ROADMAP.md section 3), so a few pixels (at most `cap`) may fall
    outside the bars, each for that reason only:
      - the resident march and each tile's march (in its frame, under its
        clip window) of the pixel's ray give the two frames' hits exactly,
        the tiled one as the nearest of all the tiles';
      - a hit or depth that differs: at the nearer frame's hit cell, the
        plane crossings of both frames are the same bits, the cell test
        hits in that frame and misses in the other, and the two differ in
        the containment of one triangle, with both slacks within 2 f32
        ulps (at the crossing's coordinates) of its edge;
      - a colour alone (by at most 1e-3): the same hit cell and depth,
        the same gradients and albedo at its corners in the tile as in the
        map, in-cell offsets that differ by at most 2 ulps between the
        frames, and from each frame's offsets the shade pass gives that
        frame's normal exactly (and the two normals differ).
    Returns each tile's sub-scene, {(y0, x0): Scene}."""
    import dataclasses
    import torch
    import hmrt_tpu_torch as T
    from hmrt_tpu_torch.api.tiled import TileSceneCache, _tile_origins
    from hmrt_tpu_torch.kernels.compact import primary_rays
    from hmrt_tpu_torch.kernels.shade_pass import shade_pass
    cfa = dataclasses.replace(cf, aux_buffers=True)
    res = T.render_frame(sc, cm, cfa)
    stats = {}
    t1 = time.perf_counter()
    tl = run_path(label, lambda: T.render_frame_tiled(source, cm, cfa, tile=TILE,
                                                      _stats=stats, **kw),
                  ("march_pass", "shade_pass"), ("render_tile",))
    first_s = time.perf_counter() - t1
    got = paths[label]
    want_k1 = 3 * stats["tiles_rendered"] + 2 * stats.get("shadow_tiles_marched", 0)
    if (got["march_pass"], got["shade_pass"]) != (want_k1, stats["tiles_rendered"]):
        raise AssertionError(f"{label}: launches {got} for {stats}")
    # every tile, culled or not, kept for the checks below
    cache = TileSceneCache(64)
    full = T.render_frame_tiled(source, cm, cfa, tile=TILE, cull=False, cache=cache, **kw)
    if not (torch.equal(full.hit, tl.hit) and torch.equal(full.depth, tl.depth)):
        raise AssertionError(f"{label}: culling changed the hit or depth of "
                             f"{int((full.depth != tl.depth).sum())} pixels")
    dc_cull = float((full.color - tl.color).abs().max())
    if dc_cull > 2e-4:
        raise AssertionError(f"{label}: culling changed the colour by {dc_cull}")
    tiles = {(y0, x0): cache.peek((y0, x0, "full"))
             for y0, x0 in _tile_origins(sc.n, TILE)}
    del cache, full

    def planes(f):
        return (torch.where(f.hit, f.depth, torch.inf).reshape(-1).double(),
                f.color.reshape(-1, 3).double())

    (t_res, c_res), (t_tl, c_tl) = planes(res), planes(tl)
    same = (torch.isinf(t_res) & torch.isinf(t_tl)) | (
        torch.isfinite(t_res) & torch.isfinite(t_tl) & ((t_tl - t_res).abs() <= 1e-4 * t_res))
    bad = ~(same & ((c_tl - c_res).abs().amax(-1) <= 2e-4))
    n_bad, pixels = int(bad.sum()), cf.width * cf.height
    n_hit = int((res.hit != tl.hit).sum())
    if n_bad > cap:
        raise AssertionError(f"{label}: {n_bad} pixels outside the bars ({n_hit} differ in "
                             f"hit) of {pixels}, more than {cap}")
    if n_bad:
        idx = torch.nonzero(bad).squeeze(1)
        rays = tuple(r.index_select(0, idx).contiguous() for r in primary_rays(cm, cfa))
        # the two frames' hits from the marches themselves
        h_r, t_r, hx_r, hy_r = march_to_end(rays, sc)
        t_r = torch.where(h_r, t_r, torch.inf)
        t_k = torch.full_like(t_r, torch.inf)
        cx_k, cy_k = torch.full_like(hx_r, -1), torch.full_like(hy_r, -1)
        clip = (1.0, 1.0 + TILE)
        for (y0, x0), sub in tiles.items():
            h, t, hx, hy = march_to_end(tile_rays(rays, x0, y0), sub, clip)
            t = torch.where(h, t, torch.inf)
            closer = t < t_k
            t_k = torch.where(closer, t, t_k)
            cx_k = torch.where(closer, hx + (x0 - 1), cx_k)
            cy_k = torch.where(closer, hy + (y0 - 1), cy_k)
        if not (torch.equal(t_r.double(), t_res[idx]) and torch.equal(t_k.double(), t_tl[idx])):
            raise AssertionError(f"{label}: the marches of the {n_bad} pixels outside the bars "
                                 "do not give the frames' hits")
        # the nearer frame's hit cell, and the tiles that hold it
        near_res = t_r < t_k
        cx = torch.where(near_res, hx_r, cx_k)
        cy = torch.where(near_res, hy_r, cy_k)
        differs = t_r != t_k
        nrm_res, nrm_tl = (f.normal.reshape(-1, 3)[idx] for f in (res, tl))
        dcol = (c_tl[idx] - c_res[idx]).abs().amax(-1)
        w_t, w_in, w_sl, w_mag, w_hit = cell_triangles(rays, cx, cy, sc.heights)
        if not torch.equal(w_hit, near_res | ~differs):
            raise AssertionError(f"{label}: the cell test in world coordinates does not give "
                                 "the resident frame's verdict at the nearer hit cell")
        explained = torch.zeros_like(differs)
        tile_hit = torch.zeros_like(differs)
        for (y0, x0), sub in tiles.items():
            mine = (cx >= x0) & (cx < x0 + TILE) & (cy >= y0) & (cy < y0 + TILE)
            lcx = torch.where(mine, cx - (x0 - 1), 1)
            lcy = torch.where(mine, cy - (y0 - 1), 1)
            l_t, l_in, l_sl, _, l_hit = cell_triangles(tile_rays(rays, x0, y0), lcx, lcy,
                                                       sub.heights)
            tile_hit |= mine & l_hit
            # a hit or depth that differs: the same crossings, and one
            # triangle's containment flips within 2 ulps of its edge
            tol = 2 * ulp32(w_mag)
            flip = ((l_in != w_in) & (w_sl.abs() <= tol) & (l_sl.abs() <= tol)).any(0)
            deciding = mine & differs & (l_hit != w_hit)
            bits = (l_t == w_t).all(0)
            explained |= deciding & bits & flip
            # a colour alone: the same hit in both frames, the tile's
            # gradients and albedo at the cell's corners equal the map's,
            # the in-cell offsets differ by rounding, and the shade pass at
            # each frame's offsets gives that frame's normal, bit for bit
            g = [torch.stack([x.reshape(-1)[(cy_ * n_ + cx_).long() + o] for o in
                              (0, 1, n_, n_ + 1)]) for x, cx_, cy_, n_ in
                 ((sc.gx, cx, cy, sc.n), (sc.gy, cx, cy, sc.n),
                  (sub.gx, lcx, lcy, sub.n), (sub.gy, lcx, lcy, sub.n))]
            data = (g[0] == g[2]).all(0) & (g[1] == g[3]).all(0)
            if cf.texture:
                for c in range(3):
                    data &= (sc.albedo[c][(cy * sc.n + cx).long()]
                             == sub.albedo[c][(lcy * sub.n + lcx).long()])
            t_hit = torch.where(torch.isfinite(t_r), t_r, 0.0)
            lr = tile_rays(rays, x0, y0)
            off_w = [torch.clamp(rays[i] + t_hit * rays[3 + i] - c.float(), 0.0, 1.0)
                     for i, c in ((0, cx), (1, cy))]
            off_l = [torch.clamp(lr[i] + t_hit * lr[3 + i] - c.float(), 0.0, 1.0)
                     for i, c in ((0, lcx), (1, lcy))]
            d_off = torch.maximum((off_w[0] - off_l[0]).abs(), (off_w[1] - off_l[1]).abs())
            rounding = (d_off > 0) & (d_off.double() <= 2 * ulp32(w_mag.amax(0)))
            ones = torch.ones_like(cx)
            n_w = torch.stack(shade_pass(ones, cx, cy, *off_w, sc.shade_rec)[:3], -1)
            n_l = torch.stack(shade_pass(ones, lcx, lcy, *off_l, sub.shade_rec)[:3], -1)
            normals = ((n_w == nrm_res).all(-1) & (n_l == nrm_tl).all(-1)
                       & (n_w != n_l).any(-1))
            explained |= (mine & ~differs & (cx_k == hx_r) & (cy_k == hy_r) & data & rounding
                          & normals & (dcol <= 1e-3))
        if not bool(explained.all()):
            bad_px = idx[~explained].tolist()
            raise AssertionError(f"{label}: {len(bad_px)} of the {n_bad} pixels outside the "
                                 f"bars are not explained by the f32 cell test: {bad_px[:10]}")
        if not torch.equal(tile_hit, ~near_res | ~differs):
            raise AssertionError(f"{label}: the tiles' cell tests do not give the tiled "
                                 "frame's verdict at the nearer hit cell")
        log(f"  {label}: {n_bad} pixels outside the bars ({n_hit} differ in hit) of "
            f"{pixels}: {int(differs.sum())} where one triangle's containment flips within 2 ulps of its "
            f"edge between the frames (the resident frame nearer on "
            f"{int(near_res.sum())}), {int((~differs).sum())} by the in-cell offsets' rounding alone")
    keep = ~bad & torch.isfinite(t_res)
    dd = float(((t_tl - t_res).abs() / t_res)[keep].max())
    dc = float((c_tl - c_res).abs().amax(-1)[~bad].max())
    t_ms = event_ms(lambda: T.render_frame_tiled(source, cm, cfa, tile=TILE, **kw), 1)
    log(f"{label} vs resident: within the bars on {pixels - n_bad} of {pixels} pixels "
        f"(depth {dd:.3g} relative, colour {dc:.3g}); culling changes no hit or depth, "
        f"colour by {dc_cull:.3g}; {stats}; first frame {first_s:.2f} s, a second "
        f"{t_ms:.1f} ms (events), {cf.width}x{cf.height}  [{card}]")
    return tiles


def quantise(x):
    """The PNG writers' 8-bit quantisation of float values in [0, 1]."""
    import numpy as np
    return (np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def compare_exact(label, pairs, close=(), bar=1e-6):
    """Raise unless every (name, a, b) of `pairs` is equal, and every one
    of `close` within `bar`; return the largest difference in `close`."""
    import torch
    for name, a, b in pairs:
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: {name} differs on {int((a != b).sum())} values")
    err = max((float((a - b).abs().max()) for _, a, b in close), default=0.0)
    if err > bar:
        raise AssertionError(f"{label}: {[n for n, _, _ in close]} differ by {err} (bar {bar})")
    return err


def across_cards(card, scene, cam, terr_path, want5):
    """B5 band-sharded over every card of the machine (NCCL), against the
    one-card frame `want5` (sha256 of colour and hit), and the runner's B5
    row on every card beside the one-card frame's time. `terr_path` holds
    the B5 map for rank 0 to read. Returns the runner's row."""
    from datetime import timedelta

    import torch
    import hmrt_tpu_torch as T
    from hmrt_tpu_torch.bench.configs import BENCH_CONFIGS
    from hmrt_tpu_torch.bench.runner import run_bench
    from hmrt_tpu_torch.distrib.dryrun import frame_digest, render_sharded_jobs
    from hmrt_tpu_torch.distrib.mesh import spawn
    cards = torch.cuda.device_count()
    cfg5 = BENCH_CONFIGS["B5"].render
    cam_args = (tuple(cam.eye.tolist()), tuple(cam.target.tolist()), 55.0)
    t0 = time.perf_counter()
    (out,) = spawn(render_sharded_jobs, cards,
                   args=([dict(source=str(terr_path), config=cfg5, camera=cam_args,
                               keep=False)],),
                   backend="nccl", timeout=timedelta(seconds=300), join_timeout=600)
    if out["frame"]["hit_diff"] or out["frame"]["color_max_err"] > 1e-6 \
            or out["frame_sha"] != frame_digest(want5.color, want5.hit):
        raise AssertionError(f"B5 over {cards} cards differs from one card: {out['frame']}")
    log(f"B5 band-sharded over {cards} cards (NCCL, {time.perf_counter() - t0:.1f} s with "
        f"start-up): equal to the one-card frame (sha256 of colour and hit)")
    one_ms, one_times = median_ms(lambda: T.render_frame(scene, cam, cfg5), 5)
    row = run_bench("B5", out_path=str(ROOT / "build" / "smoke" / f"B5_{cards}cards.json"))
    log(json.dumps(row))
    if row["chips"] != cards or row["strategy"] != "band":
        raise AssertionError(f"B5 over {cards} cards: row {row['chips']} {row['strategy']}")
    log(f"B5 over {cards} cards: {row['ms_per_frame']:.3f} ms/frame (runner, each rep from a "
        f"barrier to the slowest rank's end) against {one_ms:.3f} ms on one card "
        f"({one_times}): {one_ms / row['ms_per_frame']:.2f}x  [{card}]")
    return row


def sharding_phase(run_path, card, scene, cam, terr3, scene1, cam1, cfg1, scene4, terr4,
                   cams4):
    """Phase 14: band and frame sharding on the card (see main's docstring).
    Returns the largest colour/normal difference of the bands against the
    one-card frames, by kernel."""
    from datetime import timedelta

    import numpy as np
    import torch
    import hmrt_tpu_torch as T
    from hmrt_tpu_torch.api.flythrough import frame_camera
    from hmrt_tpu_torch.bench.configs import BENCH_CONFIGS
    from hmrt_tpu_torch.bench.runner import run_bench
    from hmrt_tpu_torch.distrib.dryrun import frame_digest, render_sharded_jobs, scene_digest
    from hmrt_tpu_torch.distrib.mesh import make_mesh, render_frame_sharded, spawn
    from hmrt_tpu_torch.kernels.compact import (FIRST_BUDGET, ROUND_BUDGET, ROUNDS, init_state,
                                                march_rounds, primary_rays,
                                                render_frame_compact)
    from hmrt_tpu_torch.kernels.raycast import fused_planes
    dev = scene.device
    b5, b4 = BENCH_CONFIGS["B5"], BENCH_CONFIGS["B4"]
    cfg5 = b5.render
    cfg5a = dataclasses.replace(cfg5, aux_buffers=True)
    H5, W5, n_bands = cfg5.height, cfg5.width, 8
    band = H5 // n_bands

    # (a) B5's 8 bands of 270 rows through compact, against the one-card frame
    def hit_cells(rays):
        st = init_state(rays, None, scene.pyr_flat[-1], n=scene.n, m=scene.m,
                        levels=scene.levels)
        hit_i, _, hx, hy = march_rounds(rays, st, scene, cell_intersect=cfg5.cell_intersect,
                                        clip=None, first_budget=FIRST_BUDGET, rounds=ROUNDS,
                                        round_budget=ROUND_BUDGET, moving=(3, 4, 5))
        return torch.stack([torch.where(hit_i != 0, hx, -1), torch.where(hit_i != 0, hy, -1)],
                           -1)

    full = T.render_frame(scene, cam, cfg5a)
    full_cells = hit_cells(primary_rays(cam, cfg5)).reshape(H5, W5, 2)
    bands, cells, sky = [], [], 0
    for r in range(n_bands):
        bc = dataclasses.replace(cfg5a, height=band)
        bands.append(run_path(f"B5 compact band {r} (rows {r * band}-{(r + 1) * band - 1})",
                              lambda: render_frame_compact(scene, cam, bc, row0=r * band,
                                                           full_height=H5),
                              ("march_pass", "shade_pass"), ("render_tile",)))
        cells.append(hit_cells(primary_rays(cam, bc, r * band, H5)).reshape(band, W5, 2))
        sky += not bool(bands[-1].hit.any())
    stacked = {k: torch.cat([getattr(f, k) for f in bands]) for k in ("color", "depth",
                                                                      "normal", "hit")}
    err_c = compare_exact("B5 compact bands", [("hit", stacked["hit"], full.hit),
                                               ("depth", stacked["depth"], full.depth),
                                               ("hit cells", torch.cat(cells), full_cells)],
                          [("colour", stacked["color"], full.color),
                           ("normal", stacked["normal"], full.normal)])
    log(f"B5 {n_bands} compact bands of {band} rows ({sky} of them sky only) stacked = the "
        f"one-card frame: hit, depth and hit cells equal, max colour/normal diff {err_c:.3g} "
        f"(bar 1e-6)")
    # each band's time on one card: an n-way band split waits for its slowest
    bc = dataclasses.replace(cfg5, height=band)
    band_ms = [median_ms(lambda: render_frame_compact(scene, cam, bc, row0=r * band,
                                                      full_height=H5), 3)[0]
               for r in range(n_bands)]
    frame_ms = median_ms(lambda: T.render_frame(scene, cam, cfg5), 3)[0]
    log(f"B5 band ms on one card (median of 3, events; rows of {band} from the top): "
        + ", ".join(f"{t:.3f}" for t in band_ms)
        + f"; sum {sum(band_ms):.3f}, the frame {frame_ms:.3f}, the slowest band "
        f"{max(band_ms):.3f} (an 8-way split at most {frame_ms / max(band_ms):.2f}x)  [{card}]")

    # the fused kernel on B1 in 8 bands of 64 rows and B3 in 2 bands of 540
    err_f = 0.0
    for label, sc, cm, cf, k in (("B1", scene1, cam1, cfg1, 8),
                                 ("B3", scene, cam, dataclasses.replace(
                                     BENCH_CONFIGS["B3"].render, backend="pallas"), 2)):
        cfa = dataclasses.replace(cf, aux_buffers=True)
        want = fused_planes(sc, cm, cfa, cells=True)
        hb = cf.height // k
        parts = [run_path(f"{label} fused band {r} (rows {r * hb}-{(r + 1) * hb - 1})",
                          lambda: fused_planes(sc, cm, dataclasses.replace(cfa, height=hb),
                                               r * hb, cf.height, cells=True),
                          ("render_tile",), ("march_pass", "shade_pass")) for r in range(k)]
        got = [torch.cat([p[i] for p in parts]) for i in range(5)]
        e = compare_exact(f"{label} fused bands", [("hit", got[3], want[3]),
                                                   ("depth", got[1], want[1]),
                                                   ("hit cells", got[4], want[4])],
                          [("colour", got[0], want[0]), ("normal", got[2], want[2])])
        err_f = max(err_f, e)
        log(f"{label} fused in {k} bands of {hb} rows stacked = the one-card frame: hit, "
            f"depth and hit cells equal, max colour/normal diff {e:.3g} (bar 1e-6)")

    # (b) a one-rank NCCL group: the sharding layer around the same render
    with make_mesh(dev, "nccl") as mesh:
        fr_s = run_path("B5 render_frame_sharded, one-rank NCCL group",
                        lambda: render_frame_sharded(scene, cam, cfg5a, mesh),
                        ("march_pass", "shade_pass"), ("render_tile",))
        compare_exact("B5 sharded on one rank", [(k, getattr(fr_s, k), getattr(full, k))
                                                 for k in ("hit", "depth", "color", "normal")])
        turns = []
        for label, fn in (("render_frame", lambda: T.render_frame(scene, cam, cfg5)),
                          ("render_frame_sharded", lambda: render_frame_sharded(
                              scene, cam, cfg5, mesh)),
                          ("render_frame_sharded", lambda: render_frame_sharded(
                              scene, cam, cfg5, mesh)),
                          ("render_frame", lambda: T.render_frame(scene, cam, cfg5))):
            ms, _ = median_ms(fn, 5)
            turns.append((label, ms))
            log(f"  B5 {label}: {ms:.3f} ms/frame (median of 5, events)  [{card}]")
    plain_ms = (turns[0][1] + turns[3][1]) / 2
    sharded_ms = (turns[1][1] + turns[2][1]) / 2
    log(f"B5 on a one-rank NCCL group: equal to render_frame (hit, depth, colour, normal); "
        f"{sharded_ms:.3f} against {plain_ms:.3f} ms/frame, the sharding layer "
        f"{sharded_ms - plain_ms:+.3f} ms  [{card}]")

    # (c) two ranks sharing the card: gloo collectives, renders on the card
    smoke = ROOT / "build" / "smoke"
    smoke.mkdir(parents=True, exist_ok=True)
    np.save(smoke / "b3.npy", terr3)
    np.save(smoke / "b4.npy", terr4)
    n3 = terr3.shape[0]
    cam_args = ((n3 * 0.5, -n3 * 0.25, float(terr3.max()) + n3 * 0.06),
                (n3 * 0.5, n3 * 0.5, float(terr3.mean())), 55.0)
    jobs = [dict(source=str(smoke / "b3.npy"), config=cfg5, camera=cam_args, keep=False),
            dict(source=str(smoke / "b4.npy"), config=b4.render,
                 orbit=(b4.frames, 2, float(terr4.max())), keep=False)]
    torch.cuda.empty_cache()  # the ranks' B4 scenes need the memory this process cached
    t0 = time.perf_counter()
    out5, out4 = spawn(render_sharded_jobs, 2, args=(jobs,), backend="gloo",
                       devices=[dev, dev], timeout=timedelta(seconds=300), join_timeout=600)
    two_s = time.perf_counter() - t0
    for label, out, sc in (("B5", out5, scene), ("B4", out4, scene4)):
        dg = out["scene_digests"]
        if not (dg == scene_digest(sc).cpu().numpy()).all():
            raise AssertionError(f"{label}: the replicated scenes differ from this process's")
    want5 = T.render_frame(scene, cam, cfg5)
    if out5["frame"]["hit_diff"] or out5["frame"]["color_max_err"] > 1e-6 \
            or out5["frame_sha"] != frame_digest(want5.color, want5.hit):
        raise AssertionError(f"B5 on two gloo ranks differs from render_frame: {out5['frame']}")
    want4 = [frame_digest(T.render_frame(scene4, frame_camera(cams4, i), b4.render).color)
             for i in range(2)]
    if out4["stack_sha"] != want4 or max(out4["stack_max_err"]) > 1e-6:
        raise AssertionError(f"B4 orbit frames 0-1 on two gloo ranks differ: "
                             f"{out4['stack_max_err']}")
    log(f"two gloo ranks on the one card ({two_s:.1f} s with start-up, scene broadcast and "
        f"checks): replicate_scene gave both ranks this process's scene bits (B5 and B4; "
        f"every plane and the shade records they pack); "
        f"B5 band-sharded equals render_frame on rank 0 and here (sha256 of colour and hit); "
        f"B4 orbit frames 0-1 frame-sharded equal render_frame bit for bit")

    # (d) every card, where there are several
    cards = torch.cuda.device_count()
    if cards > 1:
        across_cards(card, scene, cam, smoke / "b3.npy", want5)
    else:
        log("one card: B5 across cards not run here")

    # (e) the runner's frame-parallel B4 row (one rank on one card)
    row = run_path("runner B4 frame-dp", lambda: run_bench(
        "B4", frame_sharded=True, out_path=str(smoke / "B4_frame_dp.json")),
        ("march_pass", "shade_pass"), ("render_tile",))
    log(json.dumps(row))
    if row["strategy"] != "frame-dp" or row["chips"] != cards or row["frames"] % cards:
        raise AssertionError(f"runner B4 frame-dp: {row['strategy']} on {row['chips']} chips")
    log(f"runner B4 frame-dp: {row['ms_per_frame']:.3f} ms/frame over {row['frames']} frames "
        f"on {row['chips']} rank(s)  [{card}]")
    return {"compact_band_err": err_c, "fused_band_err": err_f}


def write_tiff_f32(path, a):
    """A single-strip little-endian f32 TIFF of the (H, W) array a."""
    import struct
    h, w = a.shape
    data = a.astype("<f4").tobytes()
    tags = [(256, 4, w), (257, 4, h), (258, 3, 32), (259, 3, 1), (273, 4, 0), (277, 3, 1),
            (278, 4, h), (279, 4, len(data)), (339, 3, 3)]
    start = 8 + 2 + 12 * len(tags) + 4
    ifd = struct.pack("<H", len(tags)) + b"".join(
        struct.pack("<HHI", t, typ, 1) + (struct.pack("<I", start if t == 273 else v)
                                          if typ == 4 else struct.pack("<HH", v, 0))
        for t, typ, v in tags) + struct.pack("<I", 0)
    Path(path).write_bytes(b"II" + struct.pack("<HI", 42, 8) + ifd + data)


def entry_points_phase(run_path, card, dev, scene, terr3):
    """Phase 15: the render CLI (four runs at once, as subprocesses), the
    viewer, the HTTP server in a thread and the loaders, each against the
    in-process render of the same camera. Returns the server's launches."""
    import importlib.util
    import threading
    import urllib.error
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np
    import hmrt_tpu_torch as T
    from hmrt_tpu_torch.api.flythrough import frame_camera
    from hmrt_tpu_torch.cli import serve
    from hmrt_tpu_torch.cli.render import build_parser, camera_and_config, load_terrain
    from hmrt_tpu_torch.cli.view import main as view_main
    from hmrt_tpu_torch.io.heightmap import normalize_heights
    from hmrt_tpu_torch.io.image import read_png, write_png16
    smoke = ROOT / "build" / "smoke"
    b3 = smoke / "b3.npy"      # written by phase 14
    r32 = smoke / "b3.r32"
    terr3.tofile(r32)
    from hmrt_tpu_torch.bench.configs import BENCH_CONFIGS
    r3, r4 = BENCH_CONFIGS["B3"].render, BENCH_CONFIGS["B4"].render
    shape = ["--width", r3.width, "--height", r3.height]    # B3's frame
    runs = {"plain": [b3, *shape, "--shadows", "--aux", "-o", smoke / "plain.png"],
            "sharded": [b3, *shape, "--shadows", "--sharded", "-o", smoke / "sharded.png"],
            "tile": [r32, *shape, "--tile", TILE, "-o", smoke / "tile.png"],
            "flythrough": [b3, "--width", r4.width, "--height", r4.height, "--shadows",
                           "--flythrough", 4, "-o", smoke / "fly.npy"]}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen([sys.executable, "-m", "hmrt_tpu_torch.cli.render",
                                  *map(str, argv)], cwd=ROOT, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, argv in runs.items()}
    outs = {k: p.communicate(timeout=600)[0] for k, p in procs.items()}
    cli_s = time.perf_counter() - t0
    for k, p in procs.items():
        log(f"  cli.render {k} (exit {p.returncode}): {outs[k].strip().splitlines()[-1:]}")
        if p.returncode:
            raise AssertionError(f"cli.render {k} failed:\n{outs[k][-3000:]}")

    def reference(k):
        args = build_parser().parse_args(list(map(str, runs[k])))
        terr, source, _, n, zmax, zmean = load_terrain(args)
        cam, cfg = camera_and_config(args, n, zmax, zmean, False, dev)
        return terr, source, n, zmax, cam, cfg

    terr, _, n, zmax, cam, cfg = reference("plain")
    scene_l = T.make_scene(terr, device=dev)
    fr = run_path("cli reference (render_frame)", lambda: T.render_frame(scene_l, cam, cfg),
                  ("march_pass", "shade_pass"))
    colour = quantise(fr.color.cpu().numpy())
    for k in ("plain", "sharded"):
        if not np.array_equal(read_png(str(smoke / f"{k}.png")), colour):
            raise AssertionError(f"cli.render {k}: the PNG differs from render_frame's")
    if not (np.array_equal(np.load(smoke / "plain_depth.npy"), fr.depth.cpu().numpy())
            and np.array_equal(read_png(str(smoke / "plain_normal.png")),
                               quantise(fr.normal.cpu().numpy() * 0.5 + 0.5))):
        raise AssertionError("cli.render --aux: depth or normal differs from render_frame's")
    _, source, _, _, cam_t, cfg_t = reference("tile")
    fr_t = T.render_frame_tiled(source, cam_t, cfg_t, tile=TILE, device=dev)
    tile_png = read_png(str(smoke / "tile.png"))
    if not np.array_equal(tile_png, quantise(fr_t.color.cpu().numpy())):
        raise AssertionError("cli.render --tile: the PNG differs from render_frame_tiled's")
    resident = quantise(T.render_frame(scene, cam_t, cfg_t).color.cpu().numpy())
    off = (np.abs(tile_png.astype(int) - resident).max(-1) > 1)
    if off.sum() > 10:
        raise AssertionError(f"cli.render --tile: {off.sum()} pixels over 1 LSB from resident")
    stack = np.load(smoke / "fly.npy")
    _, _, _, _, _, cfg_f = reference("flythrough")
    cams = T.orbit_flythrough(n, zmax, 4, device=dev)
    for i in range(4):
        want = T.render_frame(scene_l, frame_camera(cams, i), cfg_f).color.cpu().numpy()
        if not np.array_equal(stack[i], want):
            raise AssertionError(f"cli.render --flythrough: frame {i} differs")
    log(f"cli.render, 4 runs at once as subprocesses ({cli_s:.1f} s): the plain and --sharded "
        f"PNGs equal render_frame's colour quantised, --aux depth and normals equal; --tile "
        f"{TILE} on a .r32 equals render_frame_tiled's PNG ({int(off.sum())} pixels over 1 LSB "
        f"from the resident frame); --flythrough 4 equals render_frame frame by frame")

    # the viewer: .npy stack -> .html and .apng
    html, apng = smoke / "fly.html", smoke / "fly.apng"
    view_main([str(smoke / "fly.npy"), "-o", str(html)])
    view_main([str(smoke / "fly.npy"), "-o", str(apng)])
    if html.read_text().count("'iVBOR") != 4 or apng.read_bytes().count(b"fcTL") != 4 \
            or not np.array_equal(read_png(str(apng)), quantise(stack[0])):
        raise AssertionError("cli.view: the player or the APNG lacks the 4 frames")
    log(f"cli.view: {html.name} ({html.stat().st_size} bytes, 4 frames) and {apng.name} "
        f"(4 frames, the first equal to the stack's)")

    # the viewer server on 127.0.0.1, port 0, in a thread
    session = serve.make_session(serve.build_parser().parse_args([str(b3), "--shadows"]))
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(session))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        page = urllib.request.urlopen(base + "/", timeout=60).read()
        state = json.loads(urllib.request.urlopen(base + "/state", timeout=60).read())
        if b"hmrt_tpu viewer" not in page or len(state["eye"]) != 3:
            raise AssertionError("serve: GET / or /state is wrong")

        def post(body):
            req = urllib.request.Request(base + "/frame", data=json.dumps(body).encode(),
                                         method="POST")
            return urllib.request.urlopen(req, timeout=120).read()

        for draft in (True, False):
            params = dict(state, draft=draft)
            t1 = time.perf_counter()
            png = run_path(f"serve POST /frame ({'draft' if draft else 'full'})",
                           lambda: post(params), ("march_pass", "shade_pass"))
            ms = (time.perf_counter() - t1) * 1e3
            (smoke / "serve.png").write_bytes(png)
            want = T.render_frame(session.scene, *session.camera(params))
            if not np.array_equal(read_png(str(smoke / "serve.png")),
                                  quantise(want.color.cpu().numpy())):
                raise AssertionError(f"serve: the {'draft' if draft else 'full'} frame differs "
                                     "from render_frame's")
            log(f"  serve POST /frame draft={draft}: PNG equal to render_frame's, "
                f"{ms:.1f} ms for the request (host clock)")
        try:
            post(dict(state, eye=[0.0, float("nan"), 1.0]))
            raise AssertionError("serve: a non-finite eye did not fail")
        except urllib.error.HTTPError as e:
            if e.code != 500:
                raise AssertionError(f"serve: a non-finite eye answered {e.code}") from None
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    log("serve: GET /, GET /state, POST /frame draft and full equal to render_frame, a "
        "non-finite eye answers 500")

    # the loaders, on files written here
    a = terr3[:257, :257]   # a corner of the B3 map
    u16 = np.round(a / a.max() * 65535).astype(np.uint16)
    write_png16(str(smoke / "h.png"), u16)
    (smoke / "h.pgm").write_bytes(b"P5\n%d %d\n65535\n" % a.shape[::-1]
                                  + u16.astype(">u2").tobytes())
    write_tiff_f32(smoke / "h.tif", a)
    nd = a.copy()
    nd[3, 5] = -9999.0
    (smoke / "h.asc").write_text(
        "ncols %d\nnrows %d\nxllcorner 0\nyllcorner 0\ncellsize 1\nNODATA_value -9999\n"
        % a.shape[::-1]
        + "".join(" ".join(f"{v:.9g}" for v in row) + "\n" for row in nd))
    filled = np.where(nd == -9999.0, nd[nd != -9999.0].min(), nd)
    for name, raw in (("h.png", u16), ("h.pgm", u16), ("h.tif", a), ("h.asc", filled)):
        got = T.load_heightmap(str(smoke / name))
        if not np.array_equal(got, normalize_heights(raw.astype(np.float32))):
            raise AssertionError(f"load_heightmap {name}: differs from the written grid")
    log(f"load_heightmap: PNG (16-bit), PGM (P5, 16-bit), TIFF (f32 strip) and ESRI ASCII "
        f"(with a NODATA cell) read back equal to the grids written "
        f"(Pillow {'absent' if importlib.util.find_spec('PIL') is None else 'present'})")




#: (eye, target) of the four hostile cameras of tests/test_sanitizers.py
HOSTILE_CAMERAS = {
    "under the terrain, looking up": ((32.0, 32.0, -50.0), (32.0, 32.0, 100.0)),
    "far outside the box, looking across it": ((-500.0, -500.0, 5.0), (32.0, 32.0, 0.0)),
    "inside the terrain volume, grazing downward": ((31.5, 31.5, 1.0), (200.0, 200.0, -60.0)),
    "outside, looking away from the box": ((-100.0, -100.0, 50.0), (-200.0, -200.0, 80.0)),
}
MEMCHECK_TIMEOUT = 600  # seconds for the memcheck subprocess, start to end


def hostile_cameras(dev, run_path=None) -> float:
    """The hostile cameras on the 64^2 scene at 16x16 with Phong, shadows
    and aux buffers: K1+K2 (backend "compact") and K3 (backend "pallas")
    against their plain versions on the card (hit, depth and, for K3, hit
    cells equal; colour and normals within 1e-6), both against the torch
    oracle's hit mask, colours finite in [0, 1] and normals finite. Returns
    the largest colour or normal difference from the plain versions."""
    import torch
    import hmrt_tpu_torch as T
    from hmrt_tpu_torch.core.renderer import render_frame_oracle
    from hmrt_tpu_torch.kernels.raycast import fused_planes, fused_reference_planes
    scene = T.make_scene(T.procedural_terrain(64, seed=3), device=dev)
    base = T.RenderConfig(width=16, height=16, shading="phong", shadows=True,
                          aux_buffers=True)
    run = run_path or (lambda label, fn, want, none=(): fn())
    err = 0.0
    for name, (eye, target) in HOSTILE_CAMERAS.items():
        cam = T.Camera.create(eye=eye, target=target, device=dev)
        color, depth, normal, hit, cell = fused_reference_planes(scene, cam, base)
        want = (hit.reshape(16, 16), depth.reshape(16, 16), color.reshape(16, 16, 3),
                normal.reshape(16, 16, 3))
        fc = run(f"hostile camera {name!r} (compact)", lambda: T.render_frame(
            scene, cam, dataclasses.replace(base, backend="compact")),
            ("march_pass", "shade_pass"), ("render_tile",))
        ff = run(f"hostile camera {name!r} (pallas)", lambda: fused_planes(
            scene, cam, base, cells=True), ("render_tile",), ("march_pass", "shade_pass"))
        oracle_hit = render_frame_oracle(scene, cam, base).hit
        for path, (c, d, nrm, h) in (("compact", (fc.color, fc.depth, fc.normal, fc.hit)),
                                     ("pallas", ff[:4])):
            label = f"hostile camera {name!r}, {path}"
            pairs = [("hit", h, want[0]), ("depth", d, want[1]), ("oracle hit", h, oracle_hit)]
            if path == "pallas":
                pairs.append(("hit cell", ff[4].reshape(-1, 2), cell))
            err = max(err, compare_exact(label, pairs, (("colour", c, want[2]),
                                                        ("normal", nrm, want[3]))))
            if not bool(torch.isfinite(c).all()) or float(c.min()) < 0 or float(c.max()) > 1 \
                    or not bool(torch.isfinite(nrm).all()):
                raise AssertionError(f"{label}: colour outside [0, 1] or a normal not finite")
        log(f"  hostile camera {name!r}: {int(want[0].sum())} of 256 hits; compact (K1+K2) "
            f"and pallas (K3) equal their plain versions and the oracle's hit mask, colours "
            f"finite in [0, 1], normals finite")
    return err


def memcheck_hostile() -> str:
    """`python3 chip_smoke.py --hostile` under compute-sanitizer's memcheck,
    every tensor its own allocation. Fails on a non-zero exit and on running
    past MEMCHECK_TIMEOUT; returns "clean", "no compute-sanitizer" (no
    binary in the toolkit) or "device not supported" (the sanitizer says it
    cannot attach to this card, so it checked nothing)."""
    import os
    import signal
    from torch.utils.cpp_extension import CUDA_HOME
    tool = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "compute-sanitizer"
    if not tool.is_file():
        log(f"memcheck: no compute-sanitizer at {tool}; the memcheck run is skipped")
        return "no compute-sanitizer"
    cmd = [str(tool), "--tool", "memcheck", "--error-exitcode", "1", sys.executable,
           str(ROOT / "chip_smoke.py"), "--hostile"]
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out = proc.communicate(timeout=MEMCHECK_TIMEOUT)[0]
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"memcheck ran past its {MEMCHECK_TIMEOUT} s") from None
    lines = out.splitlines()
    log(f"memcheck: {' '.join(cmd[1:6])} ... exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s; its last lines:")
    for line in lines[-12:]:
        log("  | " + line[:200])
    if proc.returncode == 0 and "hostile cameras: ok" in lines:
        return "clean"
    if "Device not supported" in out and "hostile cameras: ok" not in lines:
        log("memcheck: compute-sanitizer cannot attach to this card here (\"Device not "
            "supported\"): it checked nothing")
        return "device not supported"
    raise AssertionError(f"memcheck: exit {proc.returncode} over the hostile cameras")


def hostile_only() -> int:
    """`python3 chip_smoke.py --hostile`: the hostile cameras through the
    kernels alone (the process that memcheck runs)."""
    import torch
    hostile_cameras(torch.device("cuda"))
    torch.cuda.synchronize()
    log("hostile cameras: ok")
    return 0


def png_filter_rows(rows, bpp: int):
    """PNG scanlines of `rows` (h, stride) uint8, row y filtered with type
    y % 5 (None, Sub, Up, Average, Paeth in turn): flat uint8, one filter
    byte before each row. Vectorised over the rows, since a filter reads
    only unfiltered bytes."""
    import numpy as np
    cur = rows.astype(np.int32)
    a = np.zeros_like(cur)
    a[:, bpp:] = cur[:, :-bpp]
    b = np.zeros_like(cur)
    b[1:] = cur[:-1]
    c = np.zeros_like(cur)
    c[:, bpp:] = b[:, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    preds = (np.zeros_like(cur), a, b, (a + b) >> 1,
             np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)))
    types = np.arange(rows.shape[0]) % 5
    pred = np.stack(preds)[types, np.arange(rows.shape[0])]
    line = ((cur - pred) & 0xFF).astype(np.uint8)
    return np.concatenate([types[:, None].astype(np.uint8), line], axis=1).reshape(-1)


def host_library_phase(card):
    """The host library on this machine: B3's 4096^2 terrain against the
    numpy spec and a 2049^2 16-bit grey PNG whose rows cycle through the
    five filters against the Python unfilter, bit for bit, both timed.
    Returns a dict of the times (s)."""
    import struct
    import zlib
    import numpy as np
    import hmrt_tpu_torch as T
    from hmrt_tpu_torch.io import image as image_io
    from hmrt_tpu_torch.io.heightmap import procedural_terrain_reference
    from hmrt_tpu_torch.io.native import png_unfilter
    out = {}
    t0 = time.perf_counter()
    terr = T.procedural_terrain(4096, seed=3)
    out["fbm_4096_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = procedural_terrain_reference(4096, seed=3)
    out["fbm_4096_spec_s"] = time.perf_counter() - t0
    if not np.array_equal(terr, want):
        raise AssertionError(f"host fBm differs from the numpy spec on "
                             f"{int((terr != want).sum())} of 4096^2 samples")
    log(f"fBm terrain 4096^2 (B3's, seed 3): host library {out['fbm_4096_s']:.3f} s, numpy "
        f"spec {out['fbm_4096_spec_s']:.3f} s, bit-equal  [{card}]")
    # B4's 8192^2 map: for a power-of-two n both linspace steps are exact,
    # so 8192^2 adds only rows to what 4096^2 checks (its spec takes ~35 s)
    t0 = time.perf_counter()
    T.procedural_terrain(8192, seed=3)
    out["fbm_8192_s"] = time.perf_counter() - t0
    log(f"fBm terrain 8192^2 (B4's, seed 3): host library {out['fbm_8192_s']:.3f} s  [{card}]")
    n = 2049
    dem = T.procedural_terrain(n, seed=3)
    img = ((dem - dem.min()) / np.ptp(dem) * 65535).astype(np.uint16)
    raw = png_filter_rows(img.astype(">u2").view(np.uint8).reshape(n, 2 * n), 2)
    smoke = ROOT / "build" / "smoke"
    smoke.mkdir(parents=True, exist_ok=True)
    path = smoke / "dem16_filtered.png"

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", n, n, 16, 0, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + chunk(b"IEND", b""))
    t0 = time.perf_counter()
    got = image_io.read_png(str(path))
    out["png_read_2049_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = png_unfilter(raw, n, 2 * n, 2)
    out["png_unfilter_2049_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    spec = image_io._unfilter(raw, n, 2 * n, 2)
    out["png_unfilter_2049_spec_s"] = time.perf_counter() - t0
    if not (np.array_equal(rows, spec) and np.array_equal(got.reshape(n, n), img)
            and np.array_equal(spec.view(">u2"), img)):
        raise AssertionError("PNG unfilter: the host library, read_png and the Python "
                             "spec do not all give the image written")
    log(f"PNG 2049^2 16-bit grey, rows filtered 0-4 in turn: read_png {out['png_read_2049_s']:.3f}"
        f" s (unfilter {out['png_unfilter_2049_s']:.4f} s), Python spec unfilter "
        f"{out['png_unfilter_2049_spec_s']:.3f} s, bit-equal  [{card}]")
    return out


def golden_b4(run_path, dev) -> None:
    """tests/golden/b4_64.npy (the JAX oracle's B4-class frame: Phong, fog
    and the bench albedo on the 64^2 terrain) against the card's compact
    and fused renders of the same scene, within 1 LSB."""
    import numpy as np
    import hmrt_tpu_torch as T
    from hmrt_tpu_torch.bench.configs import bench_albedo
    golden = np.load(ROOT / "tests" / "golden" / "b4_64.npy").astype(int)
    terr = T.procedural_terrain(64, seed=3)
    scene = T.make_scene(terr, albedo=bench_albedo(terr), device=dev)
    cam = T.Camera.create(eye=(32.0, -20.0, float(terr.max()) + 12.0),
                          target=(32.0, 32.0, float(terr.mean())), device=dev)
    base = T.RenderConfig(width=64, height=64, traversal="maxmip", shading="phong", fog=True,
                          texture=True)
    for backend, want in (("compact", ("march_pass", "shade_pass")),
                          ("pallas", ("render_tile",))):
        fr = run_path(f"B4-class golden 64x64 ({backend})", lambda: T.render_frame(
            scene, cam, dataclasses.replace(base, backend=backend)), want)
        diff = np.abs(quantise(fr.color.cpu().numpy()).astype(int) - golden)
        if diff.max() > 1:
            raise AssertionError(f"B4-class golden, {backend}: {(diff > 1).sum()} values off "
                                 f"by more than 1 LSB (max {diff.max()})")
        log(f"  B4-class golden, {backend}: within 1 LSB of tests/golden/b4_64.npy "
            f"({(diff == 1).sum()} values off by 1)")


TAIL_RAYS = 8192     # B3 tail survivors that K1's tail modes are held to plain on
STRIDES = (4, 8, 16)  # the relaxed tail's strides in cells


def tail_survivors(scene, cam, cfg, count: int = TAIL_RAYS):
    """About `count` of the frame's rays that reach the compact path's tail:
    the rays alive after pass 0 and the first sorted round (a per-ray budget
    composes), forced to level 0 and sorted by column as the tail round
    takes them. Returns (rays, state, results, rays alive before the tail)."""
    import torch
    from hmrt_tpu_torch.kernels.compact import (FIRST_BUDGET, ROUND_BUDGET, column_key,
                                                empty_results, force_level0, init_state,
                                                primary_rays)
    from hmrt_tpu_torch.kernels.march_pass import march_pass
    rays = primary_rays(cam, cfg)
    p = rays[0].shape[0]
    st0 = init_state(rays, None, scene.pyr_flat[-1], n=scene.n, m=scene.m, levels=scene.levels)
    st, res = march_pass(rays, st0, empty_results(p, rays[0].device), scene.pyr_flat,
                         scene.heights, scene.corners, n=scene.n, m=scene.m,
                         levels=scene.levels, budget=FIRST_BUDGET + ROUND_BUDGET)
    alive = torch.nonzero(st[0] != 0).squeeze(1)
    pick = torch.unique(alive[torch.linspace(0, alive.numel() - 1, min(count, alive.numel()),
                                             device=alive.device).long()])
    t_rays = tuple(r.index_select(0, pick) for r in rays)
    t_state = force_level0(t_rays, tuple(x.index_select(0, pick) for x in st))
    order = torch.argsort(column_key(t_state, max(scene.m // 32, 1)))
    return (tuple(r.index_select(0, order).contiguous() for r in t_rays),
            tuple(x.index_select(0, order).contiguous() for x in t_state),
            tuple(x.index_select(0, pick).index_select(0, order).contiguous() for x in res),
            alive.numel())


def plain_tail(rays, state, results, scene, relax, counter, cell_intersect="triangle",
               group=1):
    """The plain version of an unbudgeted tail pass: the exact tail as
    march_pass_reference runs it for `group` (1: one lane a ray, passing
    under the terrain by blocks; 32: the lane groups' walk, cell by cell to
    the floor), "old" for the old walk (l0_step over every cell, whose hits
    every form must give), or l0_step_relaxed when `relax` is set, with
    `relax` an int or an int32 tensor of one stride per ray: a stride enters
    the step only as the f32 product stride * min|1/d|, the same bits either
    way. Returns (state, results) planes."""
    import torch
    from hmrt_tpu_torch.traversal.intersect import INTERSECTORS, SURFACES
    from hmrt_tpu_torch.traversal.march import (l0_step, l0_step_relaxed, ray_box_range,
                                                ray_inverses, record_corners, relaxed_planes,
                                                run_masked)
    from hmrt_tpu_torch.kernels.march_pass import UNBUDGETED, march_pass_reference
    if not (isinstance(relax, torch.Tensor) or relax) and group != "old":
        return march_pass_reference(rays, state, results, scene.pyr_flat, scene.heights,
                                    n=scene.n, m=scene.m, levels=scene.levels,
                                    budget=UNBUDGETED, cell_intersect=cell_intersect,
                                    counter=counter, l0_only=True, group=group,
                                    pyr_min=scene.pyr_min_flat)
    ox, oy, oz, dx, dy, dz = rays
    inv_x, inv_y = ray_inverses(dx, dy)
    _, t1, _ = ray_box_range(ox, oy, dx, dy, float(scene.n - 1))
    ray = (ox, oy, oz, dx, dy, dz, inv_x, inv_y, t1)
    alive, t, lvl, icx, icy = state
    hit, t_hit, hx, hy = results
    st = dict(t=t, lvl=lvl, icx=icx, icy=icy, alive=alive != 0, hit=hit != 0, t_hit=t_hit,
              hx=hx, hy=hy)
    corners = record_corners(scene.heights.reshape(-1), scene.n, scene.m)
    gmax = scene.pyr_flat[-1]
    kw = dict(m=scene.m, intersector=INTERSECTORS[cell_intersect], counter=counter)
    if isinstance(relax, torch.Tensor) or relax:
        st.update(relaxed_planes(t))
        st = run_masked(lambda s: l0_step_relaxed(ray, s, corners, gmax, **kw,
                                                  surface=SURFACES[cell_intersect],
                                                  stride=relax),
                        st, UNBUDGETED)
    else:
        st = run_masked(lambda s: l0_step(ray, s, corners, gmax, **kw), st, UNBUDGETED)
    return ((st["alive"].to(torch.int32), st["t"], st["lvl"], st["icx"], st["icy"]),
            (st["hit"].to(torch.int32), st["t_hit"], st["hx"], st["hy"]))


#: the level-0 tail's instances held to the plain tail: the label, as in
#: march_pass.mode_launches, and the lanes a ray the instance is forced to
TAIL_GROUPS = (("l0", 1), ("l0_g32", 32))


def hold_tail(label, tail, scene, plain, run_kw, card, old=None):
    """One instance of K1's tail (`run_kw`: relax, group) against the plain
    tail on the same rays: its counting and timed launches must equal the
    plain planes and per-ray counts exactly. `tail` is (rays, state,
    results); `plain` is (out, WorkCounter, plain ms, lanes of the plain
    run that are these rays). `old`: the old walk's (out, WorkCounter), on
    the same lanes, whose hit, t_hit, hx and hy the instance must give.
    Returns the kernels line's entry: error, ms, plain ms, bound, steps,
    tests, the longest ray, hits, and the per-ray steps (key "lane_steps",
    dropped before printing)."""
    import torch
    from hmrt_tpu_torch.bench.floor import OPS_PER_STEP, OPS_PER_TEST, bound, march_bytes
    from hmrt_tpu_torch.kernels.march_pass import UNBUDGETED, march_pass
    t_rays, t_state, t_res = tail
    out, work, plain_ms, lanes = plain
    p = t_rays[0].shape[0]
    dev = t_rays[0].device
    want = tuple(x[lanes] for x in out[0]), tuple(x[lanes] for x in out[1])
    steps, tests = work.lane_steps[lanes], work.lane_tests[lanes]
    kw = dict(n=scene.n, m=scene.m, levels=scene.levels, budget=UNBUDGETED, l0_only=True,
              pyr_min=scene.pyr_min_flat, **run_kw)
    args = (t_rays, t_state, t_res, scene.pyr_flat, scene.heights, scene.corners)
    cnt = torch.empty((2, p), dtype=torch.int32, device=dev)
    counted = march_pass(*args, counts=cnt, **kw)
    timed = march_pass(*args, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for got in (counted, timed):
        for name, a, b in zip(STATE + RESULTS, got[0] + got[1], want[0] + want[1]):
            if not torch.equal(a, b):
                raise AssertionError(f"march_pass {label}: plane {name} differs from the plain "
                                     f"tail on {int((a != b).sum())} lanes")
            err = max(err, float((a.double() - b.double()).abs().max()))
    if not (torch.equal(cnt[0], steps) and torch.equal(cnt[1], tests)):
        raise AssertionError(f"march_pass {label}: counting instance differs from the plain "
                             "WorkCounter")
    old_note = ""
    if old is not None:
        old_res = tuple(x[lanes] for x in old[0][1])
        for name, a, b in zip(RESULTS, timed[1], old_res):
            if not torch.equal(a, b):
                raise AssertionError(f"march_pass {label}: {name} differs from the old walk's "
                                     f"on {int((a != b).sum())} lanes")
        old_steps = int(old[1].lane_steps[lanes].sum(dtype=torch.int64))
        old_note = (f"; hit, t_hit and cells equal the old walk's, whose {old_steps} steps and "
                    f"{int(old[1].lane_tests[lanes].sum(dtype=torch.int64))} cell tests fall to")
    ms = kernel_ms(lambda: march_pass(*args, **kw), "march_pass_kernel", 10)
    n_steps, n_tests = int(steps.sum(dtype=torch.int64)), int(tests.sum(dtype=torch.int64))
    # bytes: the lanes' planes and, for a bound, every distinct terrain
    # value the plain loop read (all strides together for the relaxed)
    b = bound(march_bytes(p, int(torch.count_nonzero(cnt[0]))) + work.unique_bytes(),
              n_steps * OPS_PER_STEP + n_tests * OPS_PER_TEST)
    entry = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
             "bound_by": b[1], "library_ms": None, "steps": n_steps, "tests": n_tests,
             "longest": int(cnt[0].max()), "hits": int(want[1][0].sum()), "lane_steps": cnt[0]}
    if old is not None:
        entry["old_steps"] = old_steps
    log(f"  march_pass {label} on {p} tail rays: 9 planes and per-ray counts equal the plain "
        f"tail's{old_note}; {entry['hits']} hits, {n_steps} steps (longest ray "
        f"{entry['longest']}), {n_tests} cell tests; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.1f} ms, bound {b[0]:.4f} ms ({b[1]})  [{card}]")
    return entry


def tail_launches(render, march_pass) -> list:
    """The inputs of every exact level-0 tail launch of march_pass (l0_only
    set, relax 0) in one call of render(): [(args, kwargs), ...] in launch
    order."""
    import hmrt_tpu_torch.kernels.compact as compact
    seen = []

    def spy(*args, **kw):
        if kw.get("l0_only") is not False and not kw.get("relax"):
            seen.append((args, dict(kw)))
        return march_pass(*args, **kw)

    compact.march_pass = spy
    try:
        render()
    finally:
        compact.march_pass = march_pass
    return seen


def live_plain(launch, scene, group=1):
    """The plain version of a captured march_pass launch (tail_launches) on
    its live lanes alone: march_pass_reference with the launch's arguments
    (the level-0 tail as `group` marches it, 1 or 32, or the max-mip pass
    when its "auto" flag reads false; "old" for the old walk, l0_step over
    every cell) and a WorkCounter. Returns (the live lanes' indices, their
    (rays, state, results), their plain (state, results), the WorkCounter,
    the plain run's ms)."""
    import torch
    from hmrt_tpu_torch.kernels.march_pass import march_pass_reference
    from hmrt_tpu_torch.traversal.march import WorkCounter
    args, kw = launch
    live = torch.nonzero(args[1][0] != 0).squeeze(1)
    sub = tuple(tuple(x.index_select(0, live).contiguous() for x in planes)
                for planes in args[:3])
    work = WorkCounter(scene.pyr_flat.shape[0], scene.n, live.device, lanes=live.numel())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if group == "old":
        out = plain_tail(*sub, scene, 0, work, kw["cell_intersect"], group="old")
    else:
        out = march_pass_reference(*sub, scene.pyr_flat, scene.heights, counter=work,
                                   group=group, **{k: kw[k] for k in (
                                       "n", "m", "levels", "budget", "cell_intersect", "clip",
                                       "l0_only", "relax", "pyr_min")})
    torch.cuda.synchronize()
    return live, sub, out, work, 1e3 * (time.perf_counter() - t0)


def hold_launch(label, launch, plains, card, old=None) -> dict:
    """A tail launch as the main path made it (tail_launches), at its full
    width, replayed with every lane group: "auto" and each of TAIL_GROUPS.
    Its counting and its timed launch must equal the plain version of the
    march it ran in all 9 planes and in the per-ray counts: on the live
    lanes the plain run in `plains` (live_plain) under the instance's name
    ("l0", "l0_g32", or "maxmip" for a launch whose flag reads false), the
    dead lanes as they came with 0 steps and 0 tests, which is what the
    plain version leaves them. Each group must run its instance ("auto":
    one lane a ray; march_pass.mode_launches), or max-mip when the
    launch's flag reads false. `old`: the old walk's live_plain, whose hit, t_hit, hx and hy
    every group must give. Returns the rays, the live rays, the plain ms
    and, by group, the kernel's ms, the instance it ran and its steps and
    cell tests, and the warp efficiency of one lane a ray."""
    import torch
    from hmrt_tpu_torch.kernels.march_pass import march_pass
    args, kw = launch
    p = args[0][0].shape[0]
    live = next(iter(plains.values()))[0]
    tail = bool(kw["l0_only"])
    entry = {"rays": p, "live": int(live.numel()), "tail": tail, "max_abs_err": 0.0,
             "plain_ms": {k: v[4] for k, v in plains.items()}}
    for group in ("auto", *(g for _, g in TAIL_GROUPS)):
        kw_g = {**kw, "group": group}
        cnt = torch.empty((2, p), dtype=torch.int32, device=live.device)
        march_pass.mode_launches.reset()
        got = (march_pass(*args, **{**kw_g, "counts": cnt}), march_pass(*args, **kw_g))
        ran = [k for k, v in march_pass.mode_launches.read().items() if v]
        may = (("maxmip",) if not tail else ("l0",) if group == "auto"
               else tuple(k for k, g in TAIL_GROUPS if g == group))
        if len(ran) != 1 or ran[0] not in may:
            raise AssertionError(f"{label}, group {group}: the launches ran {ran}, not one "
                                 f"of {may}")
        _, _, out, work, _ = plains[ran[0]]
        want = tuple(x.clone().index_copy_(0, live, o)
                     for x, o in zip(args[1] + args[2], out[0] + out[1]))
        want_cnt = torch.zeros((2, p), dtype=torch.int32, device=live.device)
        want_cnt[0].index_copy_(0, live, work.lane_steps)
        want_cnt[1].index_copy_(0, live, work.lane_tests)
        for planes in got:
            for name, a, b in zip(STATE + RESULTS, planes[0] + planes[1], want):
                if not torch.equal(a, b):
                    raise AssertionError(f"{label}, group {group}: plane {name} differs from "
                                         f"the plain version on {int((a != b).sum())} lanes")
            if old is not None:
                old_want = tuple(x.clone().index_copy_(0, live, o)
                                 for x, o in zip(args[2], old[2][1]))
                for name, a, b in zip(RESULTS, planes[1], old_want):
                    if not torch.equal(a, b):
                        raise AssertionError(f"{label}, group {group}: {name} differs from "
                                             f"the old walk's on {int((a != b).sum())} lanes")
        if not torch.equal(cnt, want_cnt):
            raise AssertionError(f"{label}, group {group}: per-ray counts differ from the "
                                 "plain WorkCounter")
        entry[str(group)] = {"ms": kernel_ms(lambda: march_pass(*args, **kw_g),
                                             "march_pass_kernel", 5), "ran": ran[0],
                             "steps": int(cnt[0].sum(dtype=torch.int64)),
                             "tests": int(cnt[1].sum(dtype=torch.int64))}
        if group == 1 and tail and live.numel():
            lane = cnt[0].index_select(0, live)
            entry["warp_efficiency_one_lane"] = warp_efficiency(
                [lane], lambda st: torch.nn.functional.pad(st, (0, -st.shape[0] % 32))
                .reshape(-1, 32))
    if old is not None:
        entry["old_steps"] = int(old[3].steps)
        entry["old_tests"] = int(old[3].tests)
    log(f"  {label}: {p} lanes, {entry['live']} live, flag {tail}; 9 planes and per-ray "
        f"counts equal the plain version of the march each group ran ("
        + ", ".join(f"{k} {v:.1f} ms" for k, v in entry["plain_ms"].items()) + ")"
        + ("" if old is None else
           f"; hit, t_hit and cells equal the old walk's ({entry['old_steps']} steps, "
           f"{entry['old_tests']} cell tests)")
        + "; " + ", ".join(f"{g} ({entry[g]['ran']}) {entry[g]['ms']:.4f} ms, "
                           f"{entry[g]['steps']} steps, {entry[g]['tests']} tests"
                           for g in entry if g in ("auto", "1", "32"))
        + (f"; one lane a ray keeps {100 * entry['warp_efficiency_one_lane']:.1f}% of its "
           "warps' lanes busy" if "warp_efficiency_one_lane" in entry else "")
        + f"  [{card}]")
    return entry


def parent_raygen_moves(sc, cm, cf) -> dict:
    """Pixels of the frame (with its depth and normal buffers) whose hit,
    depth or colour move when raygen's norm takes torch's f32 `sqrt`, as it
    did before its f64 root, on the same device."""
    import torch
    import hmrt_tpu_torch as T
    import hmrt_tpu_torch.types as types
    cf = dataclasses.replace(cf, aux_buffers=True)
    now = T.render_frame(sc, cm, cf)
    norm = types._norm
    types._norm = lambda v: torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                                       + v[..., 2] * v[..., 2])
    try:
        before = T.render_frame(sc, cm, cf)
    finally:
        types._norm = norm
    return {"hit": int((now.hit != before.hit).sum()),
            "depth": int((now.depth != before.depth).sum()),
            "color": int((now.color != before.color).any(-1).sum())}


def grazing_tail_phase(run_path, card, dev, scene, cam, cfg, scene4, cam40, cfg4,
                       main_modes) -> dict:
    """Phase 16, the grazing tail. K1's level-0 tail (l0_only; one lane or 32
    lanes a ray) and relaxed tail (strides 4, 8, 16) against their plain
    versions on B3's tail survivors, and the level-0 tail's instances on
    B4's, exact, in all 9 planes and in the counting instance's per-ray
    counts, each timed beside its plain version (with its WorkCounter) and
    its bound; B3's tail warp efficiency at one lane a ray; B3's shadow tail
    launch and B4's tail launch as the main path makes them, replayed with
    every lane group against the plain version on their live lanes (B4's
    16 are the rays held above); B4's latency bound by group (the longest
    chain over G, times the probe's dependent step on that ray); the raygen
    root's moves on B4; the relaxed
    tail's fidelity and time on full B3 and B4 (orbit frame 0) frames
    (bench/fidelity.py), failing on any false hit or on a B3 mismatch above
    1e-3; the longest per-ray step chain of the tail launch, counted, with
    the max-mip, the exact and the relaxed tails; the runner's B2, B3 and B4
    rows with l0_tail False and "auto". Returns march_pass's tail-mode
    entries of the kernels line. `main_modes`: march_pass's launches by
    the march they ran on the B3 and B4 main paths ({"B3": ..., "B4": ...})."""
    import torch
    import hmrt_tpu_torch as T
    from hmrt_tpu_torch.bench.fidelity import fidelity
    from hmrt_tpu_torch.bench.floor import count_frame
    from hmrt_tpu_torch.bench.latency import l0_walk
    from hmrt_tpu_torch.bench.runner import run_bench
    from hmrt_tpu_torch.kernels.march_pass import UNBUDGETED, march_pass
    from hmrt_tpu_torch.traversal.intersect import SURFACES
    from hmrt_tpu_torch.traversal.march import WorkCounter, record_corners

    t_rays, t_state, t_res, n_surv = tail_survivors(scene, cam, cfg)
    p = t_rays[0].shape[0]
    # where the tail's rays stand: below the cell surface at their position,
    # the reference's rays that entered the map's wall under the terrain
    # and march beneath it (no crossing, so no hit, and no skip either)
    ox, oy, oz, dx, dy, dz = t_rays
    t, icx, icy = t_state[1], t_state[3], t_state[4]
    z = record_corners(scene.heights.reshape(-1), scene.n, scene.m)(icx, icy)
    under = oz + t * dz <= SURFACES[cfg.cell_intersect](
        ox + t * dx - icx.to(torch.float32), oy + t * dy - icy.to(torch.float32), *z)
    log(f"B3 tail: {n_surv} rays alive after pass 0 and the first sorted round; {p} of them, "
        f"forced to level 0 and sorted by column; {int(under.sum())} of those stand below "
        f"the surface; the min pyramid the tail reads: "
        f"{scene.pyr_min_flat.numel() * 4 / 1e6:.1f} MB")
    # the plain versions: the level-0 tail of each instance (one lane a ray
    # under the terrain by blocks; 32 lanes a ray cell by cell to the
    # floor), the old walk (every cell, no min pyramid: the hits all must
    # give), and the relaxed tail at every stride in one masked loop over
    # the rays repeated once per stride (the plain loop's time is its
    # launches, whatever its width), each with its WorkCounter; plain_ms is
    # that loop's time
    plain = {}
    for label, relax, group in (("l0", 0, 1), ("l0_g32", 0, 32), ("old", 0, "old"),
                                ("relax", STRIDES, 1)):
        if relax:
            rep = len(STRIDES)
            rays_p = tuple(torch.cat([r] * rep) for r in t_rays)
            state_p = tuple(torch.cat([x] * rep) for x in t_state)
            res_p = tuple(torch.cat([x] * rep) for x in t_res)
            relax = torch.tensor(STRIDES, dtype=torch.int32, device=dev).repeat_interleave(p)
        else:
            rays_p, state_p, res_p = t_rays, t_state, t_res
        work = WorkCounter(scene.pyr_flat.shape[0], scene.n, dev, lanes=rays_p[0].shape[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain_tail(rays_p, state_p, res_p, scene, relax, work, cfg.cell_intersect,
                         group)
        torch.cuda.synchronize()
        plain[label] = (out, work, 1e3 * (time.perf_counter() - t0))
    modes = {}
    tail3 = (t_rays, t_state, t_res)
    for label, group in TAIL_GROUPS:
        modes[label] = hold_tail(label, tail3, scene, (*plain[label], slice(None)),
                                 dict(group=group), card, old=plain["old"][:2])
    for k in STRIDES:  # this stride's copy of the rays in the batched plain loop
        i = STRIDES.index(k)
        modes[f"relax{k}"] = hold_tail(f"relax{k}", tail3, scene,
                                       (*plain["relax"], slice(i * p, (i + 1) * p)),
                                       dict(relax=k), card)
    # one lane a ray, as the kernel claims them: 32 neighbours of the sorted
    # tail a warp, each warp as long as its longest ray
    eff = warp_efficiency([modes["l0"]["lane_steps"]], lambda st: torch.nn.functional.pad(
        st, (0, -st.shape[0] % 32)).reshape(-1, 32))
    log(f"  B3 tail, one lane a ray: warps of 32 sorted tail rays keep {100 * eff:.1f}% of "
        f"their lanes busy  [{card}]")

    # the main path's own tail launches at their full width: B3's primary
    # tail (513,374 live rays), B3's shadow tail (its flag reads false, no
    # ray being left; and forced, so that each group's sweep of the dead
    # rays runs) and B4's (16 live rays), each against the plain version of
    # the march each group ran and in hits against the old walk
    def plains(launch, sc):
        if not bool(launch[1]["l0_only"]):
            return {"maxmip": live_plain(launch, sc)}
        return {label: live_plain(launch, sc, group) for label, group in TAIL_GROUPS}

    def old_walk(launch, sc):  # a launch whose flag reads false runs no tail
        return live_plain(launch, sc, "old") if bool(launch[1]["l0_only"]) else None

    launches3 = tail_launches(lambda: T.render_frame(scene, cam, cfg), march_pass)
    if len(launches3) != 2:
        raise AssertionError(f"B3's frame made {len(launches3)} tail launches, not 2")
    primary3, shadow3 = launches3
    forced3 = (shadow3[0], {**shadow3[1], "l0_only": True})
    held = {"B3 primary": hold_launch("B3 primary tail launch", primary3,
                                      plains(primary3, scene), card,
                                      old=old_walk(primary3, scene)),
            "B3 shadow": hold_launch("B3 shadow tail launch", shadow3, plains(shadow3, scene),
                                     card),
            "B3 shadow, tail forced": hold_launch("B3 shadow tail launch, tail forced",
                                                  forced3, plains(forced3, scene), card,
                                                  old=old_walk(forced3, scene))}
    launches4 = tail_launches(lambda: T.render_frame(scene4, cam40, cfg4), march_pass)
    if len(launches4) != 1:
        raise AssertionError(f"B4's frame made {len(launches4)} tail launches, not 1")
    plain4 = plains(launches4[0], scene4)
    old4 = old_walk(launches4[0], scene4)
    held["B4"] = hold_launch("B4 orbit frame 0 tail launch", launches4[0], plain4, card,
                             old=old4)
    # its live rays alone, held the same way, and the latency bound of
    # their launch by group: the longest chain of cells (the lane groups'
    # walk) over G windows, each at least one step of the probe
    # (bench/latency.py: one lane, each record load waiting on the previous
    # cell's test)
    _, (r4, s4, res4), _, _, _ = plain4["l0"]
    b4_modes = {label: hold_tail(f"{label} (B4)", (r4, s4, res4), scene4,
                                 (*plain4[label][2:], slice(None)), dict(group=group), card,
                                 old=old4[2:4])
                for label, group in TAIL_GROUPS}
    out4 = plain4["l0_g32"][2]
    work4 = plain4["l0_g32"][3]
    longest = int(torch.argmax(b4_modes["l0_g32"]["lane_steps"]))
    chain = int(b4_modes["l0_g32"]["lane_steps"][longest])
    one = tuple(tuple(x[longest:longest + 1].contiguous() for x in planes)
                for planes in (r4, s4, res4))
    walk_kw = dict(steps=chain, cell_intersect=cfg4.cell_intersect)
    walk = l0_walk(one[0], one[1], scene4, **walk_kw)
    at = slice(longest, longest + 1)
    ended = dict(t=out4[0][1][at], icx=out4[0][3][at], icy=out4[0][4][at], hit=out4[1][0][at],
                 tests=work4.lane_tests[at])
    for (name, want), got in zip(ended.items(), (walk[0], *walk[2:])):
        if not torch.equal(got, want):
            raise AssertionError(f"the probe's walk ends with {name} {got.tolist()}, the "
                                 f"march with {want.tolist()}")
    if bool(walk[4]) and not torch.equal(walk[1], out4[1][1][at]):
        raise AssertionError("the probe's walk hits at another t than the march")
    probe_ms = kernel_ms(lambda: l0_walk(one[0], one[1], scene4, **walk_kw), "l0_probe_kernel",
                         5)
    step_us = 1e3 * probe_ms / chain
    kw1 = dict(n=scene4.n, m=scene4.m, levels=scene4.levels, budget=UNBUDGETED, l0_only=True,
               group=1, pyr_min=scene4.pyr_min_flat)
    one_ms = kernel_ms(lambda: march_pass(*one, scene4.pyr_flat, scene4.heights,
                                          scene4.corners, **kw1), "march_pass_kernel", 5)
    log(f"  B4 tail's longest ray, {chain} cells: the probe walks it in {probe_ms:.4f} ms "
        f"({step_us:.4f} us a dependent record load and cell test) and ends in the march's "
        f"state; march_pass at one lane a ray on it alone {one_ms:.4f} ms  [{card}]")
    # each march's chain of dependent steps on the longest ray (one lane a
    # ray: its own steps; 32 lanes: the chain of cells, 32 a window); the
    # launch's latency bound is the least of them, whichever march runs it
    windows = {label: -(-(chain if group > 1 else b4_modes[label]["longest"]) // group)
               for label, group in TAIL_GROUPS}
    least = min(windows.values()) * step_us / 1e3
    for label, group in TAIL_GROUPS:
        e = b4_modes[label]
        e["own_latency_ms"] = windows[label] * step_us / 1e3
        e["latency_bound_ms"] = least
        e["probe_us_per_step"] = step_us
        e["one_ray_ms"] = one_ms
        log(f"  B4 tail, {group} lane(s) a ray: {e['ms']:.4f} ms against a latency bound of "
            f"{least:.4f} ms (its own chain: {windows[label]} dependent steps of the longest "
            f"ray at {step_us:.4f} us, {e['own_latency_ms']:.4f} ms)  [{card}]")
    for label, _ in TAIL_GROUPS:
        modes[label]["launches"] = main_modes["B3"][label]
        modes[label]["b4_launches"] = main_modes["B4"][label]
        modes[label]["b4_tail"] = {k: v for k, v in b4_modes[label].items() if k != "lane_steps"}
    for e in modes.values():
        e.pop("lane_steps")
    moves4 = parent_raygen_moves(scene4, cam40, cfg4)
    log(f"B4 orbit frame 0 on the card, raygen's f64 root against torch's f32 sqrt: {moves4} "
        f"pixels move  [{card}]")

    fid = {}
    for name, sc, cm, cf in (("B3", scene, cam, cfg), ("B4 orbit frame 0", scene4, cam40, cfg4)):
        out = run_path(f"{name}: the relaxed tail's fidelity (bench/fidelity.py)",
                       lambda: fidelity(sc, cm, cf, STRIDES, reps=3),
                       ("march_pass", "shade_pass"), ("render_tile",))
        modes_run = march_pass.mode_launches.read()
        log(json.dumps({"config": name, **out}))
        log(f"  {name} exact tail {out['exact_ms_per_frame']:.3f} ms/frame, {out['exact_hits']} "
            f"hits; march_pass launches by instance {modes_run}  [{card}]")
        log("  stride  ms/frame  speed-up  false  missed  late  mismatch   max|dt|   p99|dt|"
            "   PSNR dB")
        for r in out["rows"]:
            log(f"  {r['stride']:6d}  {r['ms_per_frame']:8.3f}  {r['speedup_vs_exact']:8.3f}  "
                f"{r['false_hits']:5d}  {r['missed_hits']:6d}  {r['late_hits']:4d}  "
                f"{r['hit_mismatch_frac']:.3e}  {r['t_err_max']:.3e}  {r['t_err_p99']:.3e}  "
                f"{r['psnr_db']:.2f}")
            if r["false_hits"]:
                raise AssertionError(f"{name} stride {r['stride']}: {r['false_hits']} false hits")
            if name == "B3" and r["hit_mismatch_frac"] > 1e-3:
                raise AssertionError(f"B3 stride {r['stride']}: mismatch "
                                     f"{r['hit_mismatch_frac']} above 1e-3")
        fid[name] = out
        for k in STRIDES:
            modes[f"relax{k}"].setdefault("launches", 0)
            modes[f"relax{k}"]["launches"] += modes_run["relax"] // len(STRIDES)

    # the longest per-ray step chain of the tail launch (the last primary
    # march_pass launch), counted by the kernels
    for name, sc, cm, cf in (("B3", scene, cam, cfg), ("B4 orbit frame 0", scene4, cam40, cfg4)):
        row = []
        for label, tail_kw in (("max-mip", dict(l0_tail=False)), ("auto", {}),
                               ("exact l0", dict(l0_tail=True)),
                               *((f"relax {k}", dict(l0_tail=True, relax=k)) for k in STRIDES)):
            fc = count_frame(sc, cm, cf, **tail_kw)
            tail = fc.counts[fc.n_primary - 1]
            row.append(f"{label} {int(tail[0].max())} (tail launch {int(tail[0].sum())} steps, "
                       f"frame {sum(fc.totals(0))})")
        log(f"{name}, longest per-ray steps in the primary tail launch: " + "; ".join(row))

    # the runner's rows with the tail off and on "auto", in turns
    for name in ("B2", "B3", "B4"):
        for lt in (False, "auto"):
            r = run_path(f"runner {name} l0_tail={lt}", lambda: run_bench(name, l0_tail=lt),
                         ("march_pass", "shade_pass"), ("render_tile",))
            log(f"  runner {name} l0_tail={lt}: {r['ms_per_frame']:.3f} ms/frame, reps "
                f"{[round(t, 3) for t in r['all_times_ms']]}  [{card}]")
    return {"tail_modes": modes, "tail_launches": held, "b4_raygen_moves": moves4,
            "relaxed_fidelity": {k: [{key: row[key] for key in ("stride", "false_hits",
                                                                "hit_mismatch_frac")}
                                     for row in v["rows"]] for k, v in fid.items()}}


def cards_only(card) -> int:
    """`python3 chip_smoke.py --cards` on a machine with several cards:
    phase 14(d) alone, B5 across every card against one card."""
    import numpy as np
    import torch
    import hmrt_tpu_torch as T
    from hmrt_tpu_torch.bench.configs import BENCH_CONFIGS, bench_scene
    from hmrt_tpu_torch.kernels import _build
    cards = torch.cuda.device_count()
    if cards < 2:
        raise RuntimeError(f"--cards needs several cards, this machine has {cards}")
    _build.library()
    scene, cam, terr = bench_scene(BENCH_CONFIGS["B5"], device=torch.device("cuda"))
    smoke = ROOT / "build" / "smoke"
    smoke.mkdir(parents=True, exist_ok=True)
    np.save(smoke / "b3.npy", terr)
    across_cards(card, scene, cam, smoke / "b3.npy",
                 T.render_frame(scene, cam, BENCH_CONFIGS["B5"].render))
    log(card_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": cards}}))
    return 0


def main(argv=None) -> int:
    import numpy as np
    import torch
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--cards"], ["--hostile"]):
        print("usage: python3 chip_smoke.py [--cards | --hostile]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    sys.path.insert(0, str(ROOT))
    import hmrt_tpu_torch as T
    if not Path(T.__file__).resolve().is_relative_to(ROOT):
        raise RuntimeError(f"hmrt_tpu_torch imported from {T.__file__}, not this checkout")
    if argv == ["--hostile"]:
        return hostile_only()
    if argv:
        return cards_only(card)
    from hmrt_tpu_torch.api.flythrough import frame_camera, orbit_flythrough
    from hmrt_tpu_torch.bench.configs import BENCH_CONFIGS, bench_albedo, bench_scene
    from hmrt_tpu_torch.bench.floor import (OPS_PER_ALBEDO, OPS_PER_PIXEL, OPS_PER_SHADE,
                                            OPS_PER_STEP, OPS_PER_TEST, bound, count_frame,
                                            march_bytes)
    from hmrt_tpu_torch.bench.runner import ROW_KEYS, run_bench
    from hmrt_tpu_torch.core.renderer import render_frame_oracle
    from hmrt_tpu_torch.io import native
    from hmrt_tpu_torch.kernels import _build
    from hmrt_tpu_torch.kernels.compact import (FIRST_BUDGET, ROUND_BUDGET, ROUNDS,
                                                empty_results, hit_points, init_state,
                                                march_rounds, primary_rays,
                                                shadow_start)
    from hmrt_tpu_torch.kernels.march_pass import (UNBUDGETED, march_pass,
                                                   march_pass_reference)
    from hmrt_tpu_torch.kernels.raycast import (fused_planes, fused_reference_planes,
                                                render_frame_fused,
                                                render_frame_fused_reference)
    from hmrt_tpu_torch.kernels.shade_pass import shade_pass, shade_pass_reference
    from hmrt_tpu_torch.traversal.march import WorkCounter
    from hmrt_tpu_torch.types import tan_half

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {kind}")

    kernel_fns = {"march_pass": march_pass, "shade_pass": shade_pass,
                  "render_tile": render_frame_fused}
    paths = {}  # launches of each kernel on each path, each run from counts of 0
    mode_paths = {}  # march_pass's launches by template instance on each path

    def run_path(label, fn, want, none=()):
        """Drive one path with every launch count set to 0 just before and
        read just after; the kernels in `want` must have launched, those in
        `none` must not."""
        for f in kernel_fns.values():
            f.launches = 0
        march_pass.mode_launches.reset()
        out = fn()
        torch.cuda.synchronize()
        got = {k: f.launches for k, f in kernel_fns.items()}
        paths[label] = got
        mode_paths[label] = march_pass.mode_launches.read()
        log(f"{label}: launches {got}; march_pass by instance {mode_paths[label]}")
        for k in want:
            if got[k] <= 0:
                raise AssertionError(f"{label}: {k} was not launched")
        for k in none:
            if got[k]:
                raise AssertionError(f"{label}: {k} was launched")
        return out

    def phase(name):
        log(f"---- {name}  (at {time.perf_counter() - t_start:.1f} s)")

    def log_sectors(label, sec, lanes):
        """The shade pass's modelled gathers beside the distinct-bytes bound:
        sectors per hit and the distinct sectors' MB, with the lane planes'
        bytes, at the card's peak memory rate."""
        lane_mb = lanes * 4 * (5 + 6) / 1e6
        log(f"  shade_pass on the {label} lanes, modelled 32-byte sectors: "
            + "; ".join(f"{k} {v['sectors_per_hit']:.2f} per hit, {v['distinct_mb']:.1f} MB "
                        f"distinct (+{lane_mb:.1f} MB of lane planes: "
                        f"{bound((v['distinct_mb'] + lane_mb) * 1e6, 0)[0]:.4f} ms at peak)"
                        for k, v in sec.items()))

    def log_launch_counts(fc):
        steps, tests = fc.totals(0), fc.totals(1)
        for k, c in enumerate(fc.counts):
            log(f"  march_pass launch {k + 1} ({'primary' if k < fc.n_primary else 'shadow'}): "
                f"{int((c[0] > 0).sum())} rays stepped, {steps[k]} steps, {tests[k]} cell tests")

    # ---- 1. build the kernels and the host library from the checkout ------
    phase("1. build")

    def timed(fn):
        t = time.perf_counter()
        fn()
        return time.perf_counter() - t

    with ThreadPoolExecutor(2) as pool:  # nvcc and g++ at once
        builds = [pool.submit(timed, _build.library), pool.submit(timed, native.library)]
        kernels_s, native_s = (f.result() for f in builds)
    log(f"build: CUDA kernels {kernels_s:.2f} s, host library {native_s:.2f} s (g++ "
        f"{native.compiler_version()}, {native.library_path().name}); host CPUs: "
        f"os.cpu_count() {os.cpu_count()}, sched_getaffinity {len(os.sched_getaffinity(0))}")
    for line in sorted(_build.BUILD_DIR.glob("*.log"))[-1].read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas:", line.strip())

    # ---- 1b. the host library against its numpy and Python specs --------
    phase("1b. the host library: fBm terrain and PNG unfilter")
    host_times = host_library_phase(card)

    # ---- 2. the compact path: B3 through render_frame --------------------
    phase("2. B3 through render_frame (auto: compact)")
    b3 = BENCH_CONFIGS["B3"]
    cfg = b3.render
    t0 = time.perf_counter()
    scene, cam, terr3 = bench_scene(b3, device=dev)
    torch.cuda.synchronize()
    log(f"B3 scene: {scene.n}^2 samples, m={scene.m}, {scene.levels} levels, "
        f"built in {time.perf_counter() - t0:.2f} s")

    fr = run_path("B3 main path (render_frame, auto)", lambda: T.render_frame(scene, cam, cfg),
                  ("march_pass", "shade_pass"), ("render_tile",))

    def check_frame(label, f, cf):
        color = f.color
        if color.shape != (cf.height, cf.width, 3) or f.hit.shape != (cf.height, cf.width):
            raise AssertionError(f"{label} frame has shape {tuple(color.shape)}")
        if not bool(torch.isfinite(color).all()) or float(color.min()) < 0 \
                or float(color.max()) > 1:
            raise AssertionError(f"{label} colours are not finite values in [0, 1]")
        frac = float(f.hit.float().mean())
        if not 0.05 < frac < 0.95:
            raise AssertionError(f"{label} hit fraction {frac} outside (0.05, 0.95)")
        log(f"{label} frame: {cf.width}x{cf.height}, hit fraction {frac:.4f}, colours in "
            f"[{float(color.min()):.4f}, {float(color.max()):.4f}]")
        return frac

    def log_rate(label, ms, times, cf, frac):
        primary = cf.width * cf.height
        shadow = frac if cf.shadows else 0.0
        log(f"{label} warm frames (ms, CUDA events): {times}")
        log(f"{label}: {ms:.3f} ms/frame (median of {len(times)}), "
            f"{primary * (1 + shadow) / ms / 1e3:.2f} Mrays/s with shadow rays, "
            f"{primary / ms / 1e3:.2f} Mrays/s primary  [{card}]")

    hit_frac = check_frame("B3", fr, cfg)
    ms, times = median_ms(lambda: T.render_frame(scene, cam, cfg), 5)
    log_rate("B3 compact", ms, times, cfg, hit_frac)

    # ---- 3. march_pass and shade_pass vs plain at the main path's shapes --
    phase("3. march_pass and shade_pass vs their plain versions")
    rays = primary_rays(cam, cfg)
    p = rays[0].shape[0]
    idx = torch.arange(N_SAMPLE, device=dev) * (p // N_SAMPLE)
    srays_p = tuple(r.index_select(0, idx).contiguous() for r in rays)
    st0 = init_state(srays_p, None, scene.pyr_flat[-1], n=scene.n, m=scene.m,
                     levels=scene.levels)
    # budget 37 ends rays inside the kernel's second chunk of steps
    budgets = (1, 7, 37, 64, UNBUDGETED)
    work_k1 = WorkCounter(scene.pyr_flat.shape[0], scene.n, dev, lanes=N_SAMPLE)
    err_primary, res0 = compare_march("primary", srays_p, st0, scene, budgets, work_k1)
    # from a mid-march state as well: the kernel's own state after 64 steps,
    # at budgets 7 and 37 (the unbudgeted march from the start is checked
    # above; an unbudgeted plain march from here would take another ~15 s)
    mid = march_pass(srays_p, st0, res0, scene.pyr_flat, scene.heights, scene.corners,
                     n=scene.n, m=scene.m, levels=scene.levels, budget=64)[0]
    err_mid, _ = compare_march("primary, from step 64", srays_p, mid, scene, (7, 37))
    # the persistent kernel on one ray, one warp and a lane, and on more rays
    # than one resident wave of the card holds (132 SMs x 2,048 threads)
    err_edge = 0.0
    for count, bs in ((1, (37, UNBUDGETED)), (33, (37, UNBUDGETED)), (300_000, (37,))):
        # one or 33 rays from the lower screen, where they hit, or rays all over it
        pick_e = (3 * p // 4 + torch.arange(count, device=dev) if count < N_SAMPLE
                  else torch.arange(count, device=dev) * (p // count))
        e_rays = tuple(r.index_select(0, pick_e).contiguous() for r in rays)
        e_st = init_state(e_rays, None, scene.pyr_flat[-1], n=scene.n, m=scene.m,
                          levels=scene.levels)
        err_edge = max(err_edge, compare_march(f"{count} rays", e_rays, e_st, scene, bs)[0])

    args = (srays_p, st0, res0, scene.pyr_flat, scene.heights, scene.corners)
    kw = dict(n=scene.n, m=scene.m, levels=scene.levels, budget=UNBUDGETED)
    # the counting instance: each ray's steps and cell tests equal the plain
    # version's on the sample
    cnt = torch.empty((2, N_SAMPLE), dtype=torch.int32, device=dev)
    march_pass(*args, **kw, counts=cnt)
    if not (torch.equal(cnt[0], work_k1.lane_steps) and torch.equal(cnt[1], work_k1.lane_tests)):
        raise AssertionError("march_pass counting instance: per-ray counts differ from the "
                             "plain version's")
    log(f"  march_pass counting instance on the sample: {int(cnt[0].sum())} steps, "
        f"{int(cnt[1].sum())} cell tests, per ray equal to the plain WorkCounter's")
    march_ms = kernel_ms(lambda: march_pass(*args, **kw), "march_pass_kernel", 10)
    march_call_ms = event_ms(lambda: march_pass(*args, **kw), 10)
    march_plain_ms = event_ms(lambda: march_pass_reference(*args[:5], **kw), 1)
    # bytes: the lanes' planes (15 in and 9 out for a live ray, 9 and 9 for
    # a dead lane), and the distinct pyramid and height values read
    k1_bound = bound(march_bytes(N_SAMPLE, int(torch.count_nonzero(cnt[0])))
                     + work_k1.unique_bytes(),
                     int(work_k1.steps) * OPS_PER_STEP + int(work_k1.tests) * OPS_PER_TEST)
    log(f"march_pass, {N_SAMPLE} B3 primary rays unbudgeted: kernel {march_ms:.3f} ms "
        f"(wrapper call {march_call_ms:.3f} ms), plain {march_plain_ms:.3f} ms; {int(work_k1.steps)} steps, {int(work_k1.tests)} "
        f"cell tests, {work_k1.unique_bytes()} distinct bytes of terrain; bound "
        f"{k1_bound[0]:.4f} ms ({k1_bound[1]})  [{card}]")

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
    shade_args = (hit_i, hx, hy, fx, fy, scene.shade_rec, None)
    got = shade_pass(*shade_args)
    torch.cuda.synchronize()
    want = shade_pass_reference(*shade_args)
    err_shade = max(float((a - b).abs().max()) for a, b in zip(got, want))
    if err_shade > 1e-6:
        raise AssertionError(f"shade_pass differs from its plain version by {err_shade}")
    log(f"  shade_pass on all {p} lanes ({int(hit.sum())} hits): max |kernel - plain| "
        f"{err_shade:.3g} (bar 1e-6)")
    shade_ms = kernel_ms(lambda: shade_pass(*shade_args), "shade_pass_kernel", 20)
    shade_call_ms = event_ms(lambda: shade_pass(*shade_args), 20)
    shade_plain_ms = event_ms(lambda: shade_pass_reference(*shade_args), 5)
    # bytes: 5 lane planes in, 6 out, and the distinct gradient samples read
    # (whatever layout holds them, so the bound compares across layouts)
    k2_bound = bound(p * 4 * (5 + 6) + 8 * corner_samples(hit, hx, hy, scene.n),
                     int(hit.sum()) * OPS_PER_SHADE)
    k2_sectors = shade_sectors(hit, hx, hy, scene.n, False)
    log(f"shade_pass, {p} B3 lanes: kernel {shade_ms:.4f} ms (wrapper call "
        f"{shade_call_ms:.4f} ms), plain {shade_plain_ms:.4f} ms"
        f"; bound {k2_bound[0]:.4f} ms ({k2_bound[1]})  [{card}]")
    log_sectors("B3", k2_sectors, p)

    # shadow rays from the frame's hits, started in the hit cells
    srays, sstate = shadow_start(points, got[:3], hit, hx, hy, scene)
    hit_lanes = torch.nonzero(hit).squeeze(1)
    pick = hit_lanes[torch.linspace(0, hit_lanes.shape[0] - 1, min(N_SAMPLE, hit_lanes.shape[0]),
                                    device=dev).long()]
    sh_rays = tuple(r.index_select(0, pick).contiguous() for r in srays)
    sh_state = tuple(s.index_select(0, pick).contiguous() for s in sstate)
    err_shadow, res_sh = compare_march("shadow", sh_rays, sh_state, scene, budgets)
    shadow_ms = event_ms(lambda: march_pass(sh_rays, sh_state, res_sh, scene.pyr_flat,
                                            scene.heights, scene.corners, **kw), 10)
    log(f"march_pass, {sh_rays[0].shape[0]} B3 shadow rays unbudgeted: kernel "
        f"{shadow_ms:.3f} ms  [{card}]")
    torch.cuda.synchronize()

    # ---- 4. frames vs the torch oracle on the card -----------------------
    phase("4. frames vs the torch oracle")

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

    # ---- 5. the fused path: B1 through render_frame ----------------------
    phase("5. B1 through render_frame (auto: fused)")
    b1 = BENCH_CONFIGS["B1"]
    cfg1 = b1.render
    scene1, cam1, terr1 = bench_scene(b1, device=dev)
    fr1 = run_path("B1 main path (render_frame, auto)", lambda: T.render_frame(scene1, cam1, cfg1),
                   ("render_tile",), ("march_pass", "shade_pass"))
    b1_frac = check_frame("B1", fr1, cfg1)
    b1_ms, b1_times = median_ms(lambda: T.render_frame(scene1, cam1, cfg1), 5)
    log_rate("B1 fused", b1_ms, b1_times, cfg1, b1_frac)
    check_vs_oracle("B1 256^2 512x512 lambert (dda oracle)", scene1, cam1, cfg1)

    # ---- 6. B3 through the fused kernel (backend "pallas") ---------------
    phase("6. B3 through render_frame (pallas: fused)")
    cfg_f = dataclasses.replace(cfg, backend="pallas")
    f0 = render_frame_fused.launches
    frf = T.render_frame(scene, cam, cfg_f)
    torch.cuda.synchronize()
    if render_frame_fused.launches != f0 + 1:
        raise AssertionError("backend 'pallas' did not launch render_tile")
    b3f_frac = check_frame("B3 fused", frf, cfg_f)
    b3f_ms, b3f_times = median_ms(lambda: T.render_frame(scene, cam, cfg_f), 5)
    log_rate("B3 fused", b3f_ms, b3f_times, cfg_f, b3f_frac)
    b3c_ms, b3c_times = median_ms(lambda: T.render_frame(scene, cam, cfg), 5)
    log_rate("B3 compact (again, after fused)", b3c_ms, b3c_times, cfg, hit_frac)
    fa = T.render_frame(scene, cam, dataclasses.replace(cfg_f, aux_buffers=True))
    fc = T.render_frame(scene, cam, dataclasses.replace(cfg, aux_buffers=True,
                                                        backend="compact"))
    if not torch.equal(fa.hit, fc.hit) or not torch.equal(fa.depth, fc.depth):
        raise AssertionError(f"B3 fused vs compact: hit differs on "
                             f"{int((fa.hit != fc.hit).sum())} pixels, depth on "
                             f"{int((fa.depth != fc.depth).sum())}")
    dcol = float((fa.color - fc.color).abs().max())
    dnrm = float((fa.normal - fc.normal).abs().max())
    if dcol > 1e-6 or dnrm > 1e-6:
        raise AssertionError(f"B3 fused vs compact: colour {dcol}, normal {dnrm}")
    log(f"B3 fused vs compact (aux): hit and depth equal, max colour diff {dcol:.3g}, "
        f"normal {dnrm:.3g} (bar 1e-6)")

    # ---- 7. the fused kernel vs its plain version ------------------------
    phase("7. render_tile vs its plain version")

    def compare_fused(label, sc, cm, cf, row0=None, fh=None):
        """The kernel against its plain version on one frame or band, and its
        counting instance: the same planes, and per pixel the primary and
        shadow marches' steps and cell tests of the plain version. Returns
        (largest colour/normal difference, (primary, shadow) counters, the
        plain planes)."""
        got = fused_planes(sc, cm, cf, row0, fh, cells=True)
        cnt = torch.empty((4, cf.height, cf.width), dtype=torch.int32, device=dev)
        counted = fused_planes(sc, cm, cf, row0, fh, cells=True, counts=cnt)
        torch.cuda.synchronize()
        lanes = cf.height * cf.width
        works = [WorkCounter(sc.pyr_flat.shape[0], sc.n, dev, lanes=lanes) for _ in range(2)]
        want = fused_reference_planes(sc, cm, cf, row0, fh, counter=works[0],
                                      shadow_counter=works[1])
        for a, b in zip(got, counted):
            if not (a is None and b is None) and not torch.equal(a, b):
                raise AssertionError(f"render_tile {label}: the counting instance's planes "
                                     f"differ from the timed one's")
        for k, lane in enumerate(x for w in works for x in (w.lane_steps, w.lane_tests)):
            if not torch.equal(cnt[k].reshape(-1), lane):
                raise AssertionError(f"render_tile {label}: counts plane {k} differs from "
                                     f"the plain version's per-pixel counts")
        color, depth, normal, hit_k, cell = got
        for name, a, b in (("hit", hit_k.reshape(-1), want[3]),
                           ("hit cell", cell.reshape(-1, 2), want[4])) + (
                (("depth", depth.reshape(-1), want[1]),) if cf.aux_buffers else ()):
            if not torch.equal(a, b):
                raise AssertionError(f"render_tile {label}: {name} differs on "
                                     f"{int((a != b).sum())} pixels")
        err = float((color.reshape(-1, 3) - want[0]).abs().max())
        if cf.aux_buffers:
            err = max(err, float((normal.reshape(-1, 3) - want[2]).abs().max()))
        if err > 1e-6:
            raise AssertionError(f"render_tile {label}: colour or normal differs by {err}")
        hits = want[3]
        steps = sum(int(w.steps) for w in works)
        tests = sum(int(w.tests) for w in works)
        log(f"  render_tile {label}: hit, hit cells{', depth' if cf.aux_buffers else ''} "
            f"equal, max colour/normal diff {err:.3g} (bar 1e-6); {int(hits.sum())} hits, "
            f"{steps} march steps, {tests} cell tests; the counting instance's per-pixel "
            f"counts equal the plain version's")
        return err, works, want

    def fused_bound(sc, cf, works, want):
        p_ = cf.width * cf.height
        hx_, hy_ = want[4][:, 0], want[4][:, 1]
        grads = corner_samples(want[3], hx_, hy_, sc.n) * (8 + (12 if cf.texture else 0))
        out = p_ * (16 + (16 if cf.aux_buffers else 0))
        terrain = 4 * int((sum(w.pyr_reads for w in works) > 0).sum()
                          + (sum(w.height_reads for w in works) > 0).sum())
        return bound(4 * 32 + terrain + grads + out,
                     sum(int(w.steps) * OPS_PER_STEP + int(w.tests) * OPS_PER_TEST
                         for w in works) + p_ * OPS_PER_PIXEL)

    err_b1, work_b1, want_b1 = compare_fused("B1 frame, lambert", scene1, cam1, cfg1)
    scene1t = T.make_scene(terr1, albedo=bench_albedo(terr1), device=dev)
    cfg1_all = dataclasses.replace(cfg1, shading="phong", shadows=True, aux_buffers=True,
                                   fog=True, texture=True)
    err_b1all, _, _ = compare_fused("B1 frame, phong+shadows+aux+fog+texture", scene1t,
                                    cam1, cfg1_all)
    fused_ms = kernel_ms(lambda: render_frame_fused(scene1, cam1, cfg1), "render_tile_kernel",
                         20)
    fused_call_ms = event_ms(lambda: render_frame_fused(scene1, cam1, cfg1), 20)
    fused_plain_ms = event_ms(lambda: render_frame_fused_reference(scene1, cam1, cfg1), 1)
    k3_bound = fused_bound(scene1, cfg1, work_b1, want_b1)
    log(f"render_tile, B1 frame {cfg1.width}x{cfg1.height}: kernel {fused_ms:.4f} ms (wrapper "
        f"call {fused_call_ms:.4f} ms), plain "
        f"{fused_plain_ms:.3f} ms; bound {k3_bound[0]:.4f} ms ({k3_bound[1]})  [{card}]")

    # a 16-row band of B3 at the horizon, where the marches are longest: of
    # the 16-row bands from the first row with a hit down, the slowest one
    first = int(torch.nonzero(fr.hit.any(dim=1)).squeeze(1)[0])
    cfg_band = dataclasses.replace(cfg, height=16)
    cands = range(first, min(first + 16 * 12, cfg.height - 15), 16)
    band_times = {r0: event_ms(lambda: render_frame_fused(scene, cam, cfg_band, r0, cfg.height),
                               3) for r0 in cands}
    row0 = max(band_times, key=band_times.get)
    log("  B3 16-row bands, kernel ms by first row: "
        + ", ".join(f"{r0}: {t:.3f}" for r0, t in band_times.items()))
    err_band, work_band, want_band = compare_fused(
        f"B3 band rows {row0}-{row0 + 15} of {cfg.height}", scene, cam, cfg_band, row0,
        cfg.height)
    band_ms = kernel_ms(lambda: render_frame_fused(scene, cam, cfg_band, row0, cfg.height),
                        "render_tile_kernel", 10)
    band_plain_ms = event_ms(lambda: render_frame_fused_reference(
        scene, cam, cfg_band, row0, cfg.height), 1)
    band_bound = fused_bound(scene, cfg_band, work_band, want_band)
    log(f"render_tile, B3 band {cfg.width}x16 at row {row0}: kernel {band_ms:.4f} ms, plain "
        f"{band_plain_ms:.3f} ms; bound {band_bound[0]:.4f} ms ({band_bound[1]})  [{card}]")

    # the counter planes through render_frame: B1 under "auto" takes the
    # fused kernel, which returns (frame, counts) with debug_counters
    cfg1_cnt = dataclasses.replace(cfg1, debug_counters=True)
    fr1c, planes1 = run_path("B1 with debug_counters (render_frame, auto)",
                             lambda: T.render_frame(scene1, cam1, cfg1_cnt), ("render_tile",),
                             ("march_pass", "shade_pass"))
    cnt1 = torch.empty((4, cfg1.height, cfg1.width), dtype=torch.int32, device=dev)
    fused_planes(scene1, cam1, cfg1, counts=cnt1)
    fc1 = count_frame(scene1, cam1, cfg1, l0_tail=False)  # the fused march has no tail
    k = fc1.n_primary
    steps1, tests1 = fc1.totals(0), fc1.totals(1)
    floor1 = [sum(steps1[:k]), sum(tests1[:k]), sum(steps1[k:]), sum(tests1[k:])]
    sums1 = [int(x.sum(dtype=torch.int64)) for x in planes1]
    compare_exact("B1 with debug_counters", [("colour", fr1c.color, fr1.color),
                                             ("hit", fr1c.hit, fr1.hit)]
                  + [(f"counts plane {i}", x, cnt1[i]) for i, x in enumerate(planes1)])
    if sums1 != floor1:
        raise AssertionError(f"B1 counter planes sum to {sums1}, bench/floor.py counts {floor1}")
    log(f"B1 with debug_counters: frame equal to the frame without, four int32 planes equal "
        f"to fused_planes(counts=), their sums {sums1} (primary steps, tests, shadow steps, "
        f"tests) equal to bench/floor.py's count of the compact frame without the tail")

    # ---- 7b. the hostile cameras, and memcheck over their launches -------
    phase("7b. the hostile cameras of tests/test_sanitizers.py")
    err_hostile = hostile_cameras(dev, run_path)
    # raygen's tan(fov/2) on each device for the cameras' default 60 degrees
    # and the bench's 55: torch's f32 tan (the parent's raygen) and the f64
    # tan rounded to f32 that raygen takes now, which must agree
    for deg in (55.0, 60.0):
        half = {d: torch.deg2rad(torch.tensor(deg, device=d)) for d in ("cpu", "cuda")}
        old_bits = {d: torch.tan(h * 0.5).cpu().view(torch.int32).item()
                    for d, h in half.items()}
        new_bits = {d: tan_half(h).cpu().view(torch.int32).item() for d, h in half.items()}
        log(f"  tan({deg / 2} degrees) as f32 bits: torch's f32 tan {old_bits}, raygen's "
            f"rounded f64 tan {new_bits}")
        if new_bits["cpu"] != new_bits["cuda"]:
            raise AssertionError(f"raygen's tan of {deg} degrees differs between the CPU "
                                 f"and the card: {new_bits}")
    # the rays themselves: B3's on each device must be the same bits (the
    # norm's root taken in f64 and rounded, types.py::sqrt_f32); torch's f32
    # sqrt on the same 2^20 values on each device, against the correctly
    # rounded root, for the record
    b3_rays = {d: T.Camera.create(eye=tuple(cam.eye.tolist()), target=tuple(cam.target.tolist()),
                                  fov_y_deg=55.0, device=d).rays(cfg.height, cfg.width)[1].cpu()
               for d in ("cpu", "cuda")}
    vals = torch.from_numpy(np.random.default_rng(0).uniform(0.5, 4.0, 1 << 20).astype(np.float32))
    exact = torch.from_numpy(np.sqrt(vals.numpy()))
    off = {d: int((torch.sqrt(vals.to(d)).cpu() != exact).sum()) for d in ("cpu", "cuda")}
    n_diff = int((b3_rays["cpu"] != b3_rays["cuda"]).sum())
    log(f"  B3's ray directions: {n_diff} of {b3_rays['cpu'].numel()} components differ "
        f"between the CPU and the card; torch's f32 sqrt is off the correctly rounded root on "
        f"{off} of {vals.numel()} values")
    if n_diff:
        raise AssertionError(f"B3's ray directions differ between the CPU and the card on "
                             f"{n_diff} components")
    log(f"  B3 on the card, raygen's f64 root against torch's f32 sqrt: "
        f"{parent_raygen_moves(scene, cam, cfg)} pixels move  [{card}]")
    # the hostile camera's 256 hits on the card are the CPU's
    under = HOSTILE_CAMERAS["under the terrain, looking up"]
    hits = {}
    for d in ("cpu", "cuda"):
        sc_d = T.make_scene(T.procedural_terrain(64, seed=3), device=d)
        cam_d = T.Camera.create(eye=under[0], target=under[1], device=d)
        hits[d] = render_frame_oracle(sc_d, cam_d, T.RenderConfig(width=16, height=16)).hit
    if not torch.equal(hits["cuda"].cpu(), hits["cpu"]):
        raise AssertionError(f"the hostile camera under the terrain: {int(hits['cuda'].sum())} "
                             f"hits on the card, {int(hits['cpu'].sum())} on the CPU")
    log(f"  the hostile camera under the terrain: {int(hits['cuda'].sum())} of 256 hits on the "
        f"card, the CPU oracle's hit mask")
    memcheck = memcheck_hostile()

    # ---- 7c. the B4-class golden -----------------------------------------
    phase("7c. tests/golden/b4_64.npy on the card")
    golden_b4(run_path, dev)

    # ---- 8. B2 under both backends, for the "auto" split ---------------
    phase("8. B2 under both backends")
    for backend in ("compact", "pallas", "pallas", "compact"):
        cf2 = dataclasses.replace(b2.render, backend=backend)
        T.render_frame(scene2, cam2, cf2)
        b2_ms, b2_times = median_ms(lambda: T.render_frame(scene2, cam2, cf2), 3)
        log(f"B2 {backend}: {b2_ms:.3f} ms/frame (median of 3: {b2_times})  [{card}]")

    # ---- 9. where the time goes ------------------------------------------
    phase("9. where the time goes")
    cfg_ns = dataclasses.replace(cfg_f, shadows=False)
    k_ns = kernel_ms(lambda: render_frame_fused(scene, cam, cfg_ns), "render_tile_kernel", 3)
    k_all = kernel_ms(lambda: render_frame_fused(scene, cam, cfg_f), "render_tile_kernel", 3)
    log(f"B3 fused kernel alone: {k_all:.3f} ms with shadow rays, {k_ns:.3f} ms without  "
        f"[{card}]")
    # each launch of one compact B3 frame: pass 0, the sorted rounds, the
    # shade pass, the shadow rounds
    per_launch = launch_times(lambda: T.render_frame(scene, cam, cfg),
                              ("march_pass_kernel", "shade_pass_kernel"))
    k1_frame_ms = sum(ms for name, ms in per_launch if name == "march_pass_kernel")
    log("B3 compact frame, device ms per launch: "
        + ", ".join(f"{name.split('_kernel')[0]} {ms:.4f}" for name, ms in per_launch)
        + f"; march_pass {k1_frame_ms:.4f} ms over "
        f"{sum(name == 'march_pass_kernel' for name, _ in per_launch)} launches  [{card}]")
    # the two paths in turns on this card: compact, fused, fused, compact
    for label, cf3 in (("compact", cfg), ("fused", cfg_f), ("fused", cfg_f), ("compact", cfg)):
        t_ms, t_times = median_ms(lambda: T.render_frame(scene, cam, cf3), 5)
        log(f"B3 {label} in turns: {t_ms:.3f} ms/frame (median of 5: "
            f"{[round(t, 3) for t in t_times]})  [{card}]")
    profile_frames("B1 auto (fused)", lambda: T.render_frame(scene1, cam1, cfg1), b1_ms)
    profile_frames("B3 pallas (fused)", lambda: T.render_frame(scene, cam, cfg_f), b3f_ms)
    profile_frames("B3 auto (compact)", lambda: T.render_frame(scene, cam, cfg), b3c_ms)

    # ---- 10. the work of the full B3 frame, counted on the card ----------
    phase("10. the full B3 frame, counted by the kernels")
    # K1: the five launches of one compact frame, by the counting instance
    # (bench/floor.py, as the runner's --floor counts them)
    fc3 = count_frame(scene, cam, cfg)
    k1_counts, n_primary = fc3.counts, fc3.n_primary
    if not torch.equal(fc3.hit.reshape(fr.hit.shape), fr.hit):
        raise AssertionError("the counted compact march does not give the frame's hits")
    tot = [fc3.totals(0), fc3.totals(1)]
    log_launch_counts(fc3)
    # without the level-0 tail each ray takes the steps of the plain max-mip
    # march whatever the schedule: the counts the fused kernel's are held to
    fc3_mm = count_frame(scene, cam, cfg, l0_tail=False)
    if not torch.equal(fc3_mm.hit, fc3.hit):
        raise AssertionError("the B3 frame's hits differ with and without the level-0 tail")
    tot_mm = [fc3_mm.totals(0), fc3_mm.totals(1)]
    log(f"  without the level-0 tail (l0_tail=False): {sum(tot_mm[0])} steps, "
        f"{sum(tot_mm[1])} cell tests; per launch {tot_mm[0]}")
    k1_frame_bound = fc3.bound()
    k1_tail_bound = fc3.launch_bound(n_primary - 1)

    def warps_of(st):
        return torch.nn.functional.pad(st, (0, -st.shape[0] % 32)).reshape(-1, 32)

    k1_eff = warp_efficiency([c[0] for c in k1_counts], warps_of)
    prim_steps = sum(tot[0][:n_primary])
    entered = int((sum(c[0] for c in k1_counts[:n_primary]) > 0).sum())
    log(f"march_pass, the full B3 frame: {sum(tot[0])} steps, {sum(tot[1])} cell tests over "
        f"{len(k1_counts)} launches; primary rays {prim_steps / p:.1f} steps per pixel, "
        f"{prim_steps / max(entered, 1):.1f} per ray that stepped ({entered}); bound "
        f"{k1_frame_bound[0]:.4f} ms ({k1_frame_bound[1]}) against {k1_frame_ms:.4f} ms, the "
        f"primary tail launch's {k1_tail_bound[0]:.4f} ms ({k1_tail_bound[1]}; live lanes "
        f"{fc3.live()}); "
        f"one thread per ray, 32 lanes in launch order, would keep {100 * k1_eff:.1f}% of "
        f"its lanes busy  [{card}]")

    # K3: the B3 frame under "pallas", by the counting instance
    c4 = torch.empty((4, cfg.height, cfg.width), dtype=torch.int32, device=dev)
    _, _, _, hit3, cell3 = fused_planes(scene, cam, cfg_f, cells=True, counts=c4)
    if not torch.equal(hit3, fr.hit):
        raise AssertionError("the counted fused frame does not give the frame's hits")
    t3 = [int(c4[k].sum(dtype=torch.int64)) for k in range(4)]
    # the primary rays of both paths are the same bits, so they take the same
    # steps as the compact march without the level-0 tail
    k1_prim = [sum(tot_mm[0][:n_primary]), sum(tot_mm[1][:n_primary])]
    if t3[:2] != k1_prim:
        raise AssertionError(f"fused frame's primary counts {t3[:2]} differ from the "
                             f"compact frame's {k1_prim}")
    grads3 = corner_samples(hit3.reshape(-1), cell3[..., 0].reshape(-1),
                            cell3[..., 1].reshape(-1), scene.n) * 8
    k3_frame_bound = bound(4 * 32 + p * 16 + grads3, (t3[0] + t3[2]) * OPS_PER_STEP
                           + (t3[1] + t3[3]) * OPS_PER_TEST + p * OPS_PER_PIXEL)

    def patches_of(st):  # (2, H, W) primary and shadow steps -> (warps, 32, 2)
        h_, w_ = st.shape[1:]
        st = torch.nn.functional.pad(st, (0, -w_ % 8, 0, -h_ % 4))
        return (st.reshape(2, st.shape[1] // 4, 4, st.shape[2] // 8, 8)
                .permute(1, 3, 2, 4, 0).reshape(-1, 32, 2))

    k3_eff = warp_efficiency([c4[0::2]], patches_of)
    log(f"render_tile, the full B3 frame: primary {t3[0]} steps, {t3[1]} cell tests; shadow "
        f"{t3[2]} steps, {t3[3]} cell tests (compact without the tail: "
        f"{sum(tot_mm[0][n_primary:])}, {sum(tot_mm[1][n_primary:])}); bound "
        f"{k3_frame_bound[0]:.4f} ms ({k3_frame_bound[1]}) against {k_all:.4f} ms; one thread "
        f"per pixel on 8x4 patches, primary then shadow march, would keep "
        f"{100 * k3_eff:.1f}% of its lanes busy  [{card}]")

    # ---- 11. B4 resident: the 8192^2 flythrough through render_frame -----
    phase("11. B4 resident: the scripted orbit over the 8192^2 map")
    b4 = BENCH_CONFIGS["B4"]
    cfg4 = b4.render
    t0 = time.perf_counter()
    scene4, _, terr4 = bench_scene(b4, device=dev)
    torch.cuda.synchronize()
    b4_build_s = time.perf_counter() - t0
    sizes = {"heights": scene4.heights, "pyramid": scene4.pyr_flat,
             "min pyramid": scene4.pyr_min_flat, "corner records": scene4.corners, "gx, gy": (scene4.gx, scene4.gy),
             "planar albedo": scene4.albedo, "shade records": scene4.shade_rec,
             "albedo records": scene4.albedo_rec}
    mb = {k: sum(x.numel() * x.element_size() for x in (v if isinstance(v, tuple) else (v,)))
          / 1e6 for k, v in sizes.items()}
    log(f"B4 scene: {scene4.n}^2 samples, m={scene4.m}, {scene4.levels} levels, built in "
        f"{b4_build_s:.2f} s (fBm, albedo, upload, pyramid, records); on the card (MB): "
        + ", ".join(f"{k} {v:.1f}" for k, v in mb.items()) + f", total {sum(mb.values()):.1f}")
    cams4 = orbit_flythrough(b4.map_n, float(terr4.max()), b4.frames, device=dev)
    cam40 = frame_camera(cams4, 0)
    fr4 = run_path("B4 main path (render_frame, auto, orbit frame 0)",
                   lambda: T.render_frame(scene4, cam40, cfg4),
                   ("march_pass", "shade_pass"), ("render_tile",))
    b4_launches = paths["B4 main path (render_frame, auto, orbit frame 0)"]
    b4_marches = mode_paths["B4 main path (render_frame, auto, orbit frame 0)"]
    if not b4_marches["l0"] or b4_marches["l0_g32"]:
        raise AssertionError(f"B4's tail launch did not march one lane a ray: {b4_marches}")
    b4_frac = check_frame("B4 orbit frame 0", fr4, cfg4)
    b4_ms, b4_times = median_ms(lambda: T.render_frame(scene4, cam40, cfg4), 5)
    log_rate("B4 orbit frame 0", b4_ms, b4_times, cfg4, b4_frac)
    for i in (0,):   # each further orbit frame costs ~35 s of the torch oracle
        check_vs_oracle(f"B4 orbit frame {i} 8192^2 1280x720 phong+fog+texture", scene4,
                        frame_camera(cams4, i), cfg4)

    # the textured shade pass against its plain version on every lane
    rays4 = primary_rays(cam40, cfg4)
    p4 = rays4[0].shape[0]
    st4 = init_state(rays4, None, scene4.pyr_flat[-1], n=scene4.n, m=scene4.m,
                     levels=scene4.levels)
    # march_pass against its plain version on B4's rays: a strided sample
    # and every ray still marching after pass 0 and the first sorted round
    # (a per-ray budget composes), the frame's longest rays
    kw4 = dict(n=scene4.n, m=scene4.m, levels=scene4.levels)
    after4 = march_pass(rays4, st4, empty_results(p4, dev), scene4.pyr_flat, scene4.heights,
                        scene4.corners, budget=FIRST_BUDGET + ROUND_BUDGET, **kw4)[0]
    long4 = torch.nonzero(after4[0] != 0).squeeze(1)
    if not long4.numel():
        raise AssertionError("B4 frame 0 has no ray left after the first sorted round")
    pick4 = torch.unique(torch.cat([torch.arange(N_SAMPLE, device=dev) * (p4 // N_SAMPLE),
                                    long4]))
    err_b4, _ = compare_march(
        f"B4 frame 0 ({long4.numel()} rays of > {FIRST_BUDGET + ROUND_BUDGET} steps among "
        f"{pick4.numel()})", tuple(r.index_select(0, pick4).contiguous() for r in rays4),
        tuple(s.index_select(0, pick4).contiguous() for s in st4), scene4,
        (1, 37, UNBUDGETED))
    hit_i4, t_hit4, hx4, hy4 = march_rounds(rays4, st4, scene4,
                                            cell_intersect=cfg4.cell_intersect, clip=None,
                                            first_budget=FIRST_BUDGET, rounds=ROUNDS,
                                            round_budget=ROUND_BUDGET, moving=(3, 4, 5))
    hit4 = hit_i4 != 0
    if not torch.equal(hit4.reshape(fr4.hit.shape), fr4.hit):
        raise AssertionError("primary march of the B4 frame is not reproducible")
    _, fx4, fy4 = hit_points(rays4, hit4, t_hit4, hx4, hy4)
    shade4 = (hit_i4, hx4, hy4, fx4, fy4, scene4.shade_rec, scene4.albedo_rec)
    got4 = shade_pass(*shade4)
    torch.cuda.synchronize()
    want4 = shade_pass_reference(*shade4)
    err_shade_tex = max(float((a - b).abs().max()) for a, b in zip(got4, want4))
    if err_shade_tex > 1e-6:
        raise AssertionError(f"textured shade_pass differs from its plain version by "
                             f"{err_shade_tex}")
    log(f"  shade_pass, textured, on all {p4} B4 lanes ({int(hit4.sum())} hits): max "
        f"|kernel - plain| {err_shade_tex:.3g} (bar 1e-6)")
    shade_tex_ms = kernel_ms(lambda: shade_pass(*shade4), "shade_pass_kernel", 20)
    shade_tex_plain_ms = event_ms(lambda: shade_pass_reference(*shade4), 5)
    # bytes: 5 lane planes in, 6 out, and per distinct corner sample its two
    # gradients and three albedo channels
    k2_tex_bound = bound(p4 * 4 * (5 + 6) + (8 + 12) * corner_samples(hit4, hx4, hy4, scene4.n),
                         int(hit4.sum()) * (OPS_PER_SHADE + OPS_PER_ALBEDO))
    k2_tex_sectors = shade_sectors(hit4, hx4, hy4, scene4.n, True)
    log(f"shade_pass, textured, {p4} B4 lanes: kernel {shade_tex_ms:.4f} ms, plain "
        f"{shade_tex_plain_ms:.4f} ms; bound {k2_tex_bound[0]:.4f} ms ({k2_tex_bound[1]})  "
        f"[{card}]")
    log_sectors("B4", k2_tex_sectors, p4)

    # the B4 frame's march work, counted as the runner's --floor counts it,
    # against the device time of its march_pass launches
    fc4 = count_frame(scene4, cam40, cfg4)
    if not torch.equal(fc4.hit.reshape(fr4.hit.shape), fr4.hit):
        raise AssertionError("the counted B4 march does not give the frame's hits")
    log_launch_counts(fc4)
    k1_b4_bound = fc4.bound()
    per_launch4 = launch_times(lambda: T.render_frame(scene4, cam40, cfg4),
                               ("march_pass_kernel", "shade_pass_kernel"))
    k1_b4_ms = sum(ms for name, ms in per_launch4 if name == "march_pass_kernel")
    log("B4 frame, device ms per launch: "
        + ", ".join(f"{name.split('_kernel')[0]} {ms:.4f}" for name, ms in per_launch4)
        + f"; march_pass {k1_b4_ms:.4f} ms over {len(fc4.counts)} launches, "
        f"{sum(fc4.totals(0))} steps, {sum(fc4.totals(1))} cell tests; bound "
        f"{k1_b4_bound[0]:.4f} ms ({k1_b4_bound[1]})  [{card}]")
    profile_frames("B4 auto (compact)", lambda: T.render_frame(scene4, cam40, cfg4), b4_ms)

    # ---- 12. the bench runner: a row for each of B1-B5 -------------------
    phase("12. the bench runner, B1-B5")
    row_dir = ROOT / "build" / "bench_rows"
    row_dir.mkdir(parents=True, exist_ok=True)
    runner_kernels = {"B1": (("render_tile",), ("march_pass", "shade_pass")),
                      "B2": (("march_pass", "shade_pass"), ("render_tile",)),
                      "B3": (("march_pass", "shade_pass"), ("render_tile",)),
                      "B4": (("march_pass", "shade_pass"), ("render_tile",)),
                      "B5": (("march_pass", "shade_pass"), ("render_tile",))}
    for name, (want, none) in runner_kernels.items():
        out = row_dir / f"{name}.json"
        row = run_path(f"runner {name}", lambda: run_bench(name, floor=name in ("B3", "B4"),
                                                           out_path=str(out)), want, none)
        log(json.dumps(row))
        log(f"  [{card}]")
        missing = [k for k in ROW_KEYS + ("device", "strategy") if k not in row]
        if missing:
            raise AssertionError(f"runner {name}: row lacks {missing}")
        if json.loads(out.read_text()) != json.loads(json.dumps(row)):
            raise AssertionError(f"runner {name}: the row on disk differs from the row")
        if not (0 < row["ms_per_frame"] < 1e5) or row["chips"] != 1:
            raise AssertionError(f"runner {name}: ms_per_frame {row['ms_per_frame']}")
        extra = {"B3": ("lane_steps_per_frame", "march_bound_ms"),
                 "B4": ("ms_per_frame_1920x1080", "lane_steps_per_frame"),
                 "B5": ("note", "hit_frac", "sharded_mesh1_ms", "band_h270_ms")}.get(name, ())
        if any(k not in row for k in extra):
            raise AssertionError(f"runner {name}: row lacks one of {extra}")

    # ---- 13. the out-of-core tiled renderer against the resident frame ---
    phase("13. tiled: B4 in 2048-cell tiles, B3 with shadows")

    # at most the pixels the tiled frames have shown outside the bars (35
    # of B4's, 7 of B3's, the same in every call), with a little room
    alb4 = np.ascontiguousarray(scene4.albedo.cpu().numpy().T.reshape(scene4.n, scene4.n, 3))
    cache4 = check_tiled("B4 tiled (2048-cell tiles)", scene4, cam40, cfg4, terr4, 40, run_path,
                         paths, card, albedo=alb4)
    del alb4
    # march_pass against its plain version on the sub-scene of the tile that
    # the most rays enter, in its frame and under its clip window
    clip = (1.0, 1.0 + TILE)
    best = None
    for (y0, x0), sub in cache4.items():
        lr = tile_rays(rays4, x0, y0)
        st = init_state(lr, None, sub.pyr_flat[-1], n=sub.n, m=sub.m, levels=sub.levels,
                        clip=clip)
        alive = torch.nonzero(st[0] != 0).squeeze(1)
        if best is None or alive.numel() > best[0].numel():
            best = (alive, (y0, x0), sub, lr, st)
    alive, (y0, x0), sub, lr, st = best
    pick = alive[torch.linspace(0, alive.numel() - 1, min(N_SAMPLE, alive.numel()),
                                device=dev).long()]
    err_tile, _ = compare_march(
        f"B4 tile ({y0}, {x0}) sub-scene m={sub.m}, clip {clip}, {pick.numel()} of the "
        f"{alive.numel()} rays that enter it",
        tuple(r.index_select(0, pick).contiguous() for r in lr),
        tuple(x.index_select(0, pick).contiguous() for x in st), sub, (1, 37, UNBUDGETED),
        clip=clip)
    del cache4, best, sub, lr, st
    check_tiled("B3 tiled with shadows (2048-cell tiles)", scene, cam, cfg, terr3, 10, run_path,
                paths, card)

    t14 = time.perf_counter()
    phase("14. sharding on the card")
    band_errs = sharding_phase(run_path, card, scene, cam, terr3, scene1, cam1, cfg1, scene4,
                               terr4, cams4)
    log(f"phase 14 took {time.perf_counter() - t14:.1f} s")
    t15 = time.perf_counter()
    phase("15. the entry points on the card")
    entry_points_phase(run_path, card, dev, scene, terr3)
    log(f"phase 15 took {time.perf_counter() - t15:.1f} s")
    t16 = time.perf_counter()
    phase("16. the grazing tail")
    tail = grazing_tail_phase(run_path, card, dev, scene, cam, cfg, scene4, cam40, cfg4,
                              {"B3": mode_paths["B3 main path (render_frame, auto)"],
                               "B4": mode_paths["B4 main path (render_frame, auto, orbit "
                                                "frame 0)"]})
    log(f"phase 16 took {time.perf_counter() - t16:.1f} s")

    phase("done")
    launches = {k: sum(got[k] for got in paths.values()) for k in kernel_fns}
    log(f"launches over the {len(paths)} paths: {launches}")
    kernels = [
        {"name": "march_pass", "route": "cuda",
         "source": "hmrt_tpu_torch/kernels/csrc/march_pass.cu",
         "replaces": "hmrt_tpu/kernels/compact.py:80",
         "launches": launches["march_pass"],
         "max_abs_err": max(err_primary, err_mid, err_shadow, err_edge, err_b4, err_tile,
                            err_hostile,
                            *(m["max_abs_err"] for m in tail["tail_modes"].values())),
         "ms": march_ms, "plain_ms": march_plain_ms,
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1], "library_ms": None,
         "b5_bands_max_abs_err": band_errs["compact_band_err"],
         "b4_frame_launches": b4_launches["march_pass"], "b4_frame_ms": k1_b4_ms,
         "b4_frame_bound_ms": k1_b4_bound[0], "b4_frame_bound_by": k1_b4_bound[1],
         **tail},
        {"name": "shade_pass", "route": "cuda",
         "source": "hmrt_tpu_torch/kernels/csrc/shade_pass.cu",
         "replaces": "hmrt_tpu/kernels/compact.py:562",
         "launches": launches["shade_pass"],
         "max_abs_err": max(err_shade, err_shade_tex, err_hostile), "ms": shade_ms,
         "plain_ms": shade_plain_ms, "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
         "library_ms": None, "b5_bands_max_abs_err": band_errs["compact_band_err"],
         "textured_max_abs_err": err_shade_tex,
         "textured_ms": shade_tex_ms, "textured_plain_ms": shade_tex_plain_ms,
         "textured_bound_ms": k2_tex_bound[0], "textured_bound_by": k2_tex_bound[1],
         "sectors_per_hit": {k: v["sectors_per_hit"] for k, v in k2_sectors.items()},
         "textured_sectors_per_hit": {k: v["sectors_per_hit"]
                                      for k, v in k2_tex_sectors.items()}},
        {"name": "render_tile", "route": "cuda",
         "source": "hmrt_tpu_torch/kernels/csrc/render_tile.cu",
         "replaces": "hmrt_tpu/kernels/raycast.py:88",
         "launches": launches["render_tile"],
         "max_abs_err": max(err_b1, err_b1all, err_band, err_hostile),
         "ms": fused_ms, "plain_ms": fused_plain_ms,
         "bound_ms": k3_bound[0], "bound_by": k3_bound[1], "library_ms": None,
         "bands_max_abs_err": band_errs["fused_band_err"]},
    ]
    log(json.dumps({"host_library": {"build_s": native_s, **host_times,
                                     "b4_scene_build_s": b4_build_s},
                    "hostile_cameras_memcheck": memcheck}))
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
