"""One run of a cell over several cards: the port's band-sharded path.

A cell whose `chips` is above 1 runs as that many ranks, one process per
card, started by the port's own `distrib/mesh.py::spawn` (NCCL where each
rank has a card of its own; gloo on the CPU or where ranks share a card).
Every rank renders the same frames: frame i is
`render_frame_sharded(scene, cams[i % lap], config, mesh)`, which renders
the rank's band of rows and all-gathers the whole frame onto every rank,
and a synchronise.

Set-up (`run.set_up`, the one-card set-up): rank 0 makes the
configuration's inputs and builds the scene with `make_scene`,
`replicate_scene` gives every other rank the same scene (`scene_build_s`
is rank 0's host clock around both, up to a barrier after a synchronise),
each rank makes the seeded lap's cameras on its card and renders the
warm-up frames. Before that each rank binds its threads to whole cores of
its own, near its card where the card says which are near
(`hostinfo.split_cores`); after it each rank freezes what set-up made
out of the collector's reach (`gc.freeze`), since every frame waits for
the slowest rank's host. `setup_s` runs from the start of the process
that started the ranks to rank 0's first timed frame.

The window: rank 0 times each frame on its host clock, from the call to
the synchronise's return; as the frame ends in the all-gather, that is the
slowest band and the gather. The stop adds no collective and no wait to a
timed frame: once a frame ends past the window's close, rank 0 writes the
index of the next frame into a value shared with the other ranks and
renders that frame untimed. The others read the value before each frame
and stop after that index. None can finish a frame past the one rank 0
wrote before it wrote it, because each frame ends in a gather that needs
rank 0's part, so every rank renders the same frames and no collective
waits for a rank that never enters it.

`--trace 1`: every rank renders the same traced frames under its own
profiler and reads its own trace; rank 0 takes them all. The metrics that
read the trace read the pacing rank's, the rank with the most device time
outside the all-gather kernels. `band_imbalance_pct` reads every rank's
device time outside them; `gather_ms` and `gather_roofline` each
all-gather on the rank that entered it last, since a rank that enters
early spins in the kernel until the others come; `frame_roofline` and
`device_idle_pct` take the pacing rank's busy time as its band's ops and
that transfer, so the spin counts as idle (`trace_facts`). Then every
rank renders the same frames once more with the port's tracing armed
(`stages.armed_run`), and the stage metrics read the pacing rank's. The
breakdown is the pacing rank's, each name led by its rank ("rank2 ...").

The output check: rank 0 keeps the gathered frames at the seed's checked
views, frees the program's state and compares them with the plain
reference on its card, as a one-card run does; every rank's gathered
frames at those views must equal rank 0's bit for bit (`rank_frames`, an
exact comparison, limit 0).
"""

from __future__ import annotations

import gc
import hashlib
import multiprocessing
import os
import sys
import time

from port_bench import cells, hostinfo, stages
from port_bench import run as run_mod
from port_bench.trace import GATHER

#: the ranks are killed, and the run fails, once they outlast `seconds` +
#: this: under the 360 s that a run may take
JOIN_SLACK_S = 280


def band_busy_s(trace) -> float:
    """Device seconds of a rank's traced ops other than the all-gather
    kernels: the time its band took on its card."""
    return trace.op_seconds(lambda name: GATHER not in name)


def gather_seconds(traces: list) -> float:
    """Device seconds of the traced all-gathers, each taken on the rank
    whose kernel for it was shortest: the rank that entered it last, whose
    kernel waited for no other rank, so what is left is the transfer.
    (Each rank's k-th all-gather kernel belongs to the same collective.)"""
    per_rank = [[s for name, s in t.ops if GATHER in name] for t in traces]
    return sum(min(col) for col in zip(*per_rank))


def pacing_rank(busy: list) -> int:
    """The rank whose band took the most device time (the first on a
    tie): the one every frame's gather waits for."""
    return max(range(len(busy)), key=lambda r: (busy[r], -r))


def run_mesh(cell: cells.Cell, seed: int, seconds: float, traced: bool, log, t_start: float,
             devices=None, backend: str | None = None, render=None,
             join_timeout: float | None = None):
    """Set-up, window and output check of one run over `cell.chips`
    ranks; returns the result line's object and the banned modules that
    any rank found loaded. `devices` (one a rank; default: rank r on card
    r), `backend` and `render`, which replaces the port's
    `render_frame_sharded` and must be picklable (the tests break the
    timed path with it), go to the ranks. Raises when a rank raises or
    dies, or when the ranks outlast `join_timeout` (default: `seconds` +
    JOIN_SLACK_S)."""
    from hmrt_tpu_torch.distrib.mesh import spawn

    # written once by rank 0 and read by the others between frames: no lock
    stop = multiprocessing.get_context("spawn").Value("q", -1, lock=False)
    got = spawn(_rank, cell.chips,
                args=(cell.config, cell.traffic, seed, seconds, traced, t_start, stop, render),
                backend=backend, devices=devices,
                join_timeout=seconds + JOIN_SLACK_S if join_timeout is None else join_timeout,
                threads=2)
    ctx, rest = got
    out = run_mod.result(cell, ctx, traced, rest["device"], rest["checked"], rest["failed"],
                         rest["worst"], rest["limits"])
    if ctx.trace is not None:
        tag = f"rank{ctx.facts['pacing_rank']} "
        out["breakdown"] = {k: [[tag + name, s] for name, s in v]
                            for k, v in out["breakdown"].items()}
    return out, rest["banned"]


def _digest(color, hit) -> str:
    h = hashlib.sha256()
    for x in (color, hit):
        h.update(x.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def trace_facts(traces: list) -> dict:
    """What the trace metrics of a run over several cards read from every
    rank's trace: each rank's device seconds outside the all-gathers, the
    pacing rank, the gathers' transfer (`gather_seconds`), and the pacing
    rank's busy seconds without the spin of its gather kernels, its band's
    ops and the transfer (`frame_roofline` and `device_idle_pct` read that
    busy time, so the wait for the slowest host counts as idle)."""
    busy = [band_busy_s(t) for t in traces]
    pace = pacing_rank(busy)
    gather = gather_seconds(traces)
    return {"band_busy_s": busy, "pacing_rank": pace, "gather_s": gather,
            "device_busy_s": busy[pace] + gather}


def _pin(mesh, everyone, say) -> None:
    """Give this rank whole cores of its own (hostinfo.split_cores), near
    its card where that is known, so that the ranks' hosts do not share a
    core and keep the same cores from run to run."""
    import torch

    near = None
    if mesh.device.type == "cuda":
        near = hostinfo.card_local_cpus(torch.cuda.get_device_properties(mesh.device))
    cores = hostinfo.cpu_cores(os.sched_getaffinity(0))
    split = hostinfo.split_cores(cores, everyone(near))
    if split is None:
        say(f"{len(cores)} cores for {mesh.size} ranks: the ranks are not bound to cores")
        return
    threads = everyone(hostinfo.pin_threads(split[mesh.rank]))
    say(f"cores: {len(cores)} allowed; CPUs by rank {split}; threads bound by rank {threads}")


def _rank(mesh, config: dict, traffic: dict, seed: int, seconds: float, traced: bool,
          t_start: float, stop, render):
    import torch
    import torch.distributed as dist

    if render is None:
        from hmrt_tpu_torch.distrib.mesh import render_frame_sharded as render

    lead = mesh.rank == 0
    log = sys.stderr

    def say(msg):
        if lead:
            print(msg, file=log, flush=True)

    def everyone(obj) -> list:
        box = [None] * mesh.size
        dist.all_gather_object(box, obj, group=mesh.group)
        return box

    device = mesh.device
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    say(f"{mesh.size} ranks over {mesh.backend}, rank 0 on {device}"
        + (f" ({torch.cuda.get_device_name(device)}, torch {torch.__version__}, "
           f"cuda {torch.version.cuda}); peer access from card 0: "
           + str([torch.cuda.can_device_access_peer(device.index, r)
                  for r in range(torch.cuda.device_count()) if r != device.index])
           if cuda else ""))
    _pin(mesh, everyone, say)
    su = run_mod.set_up(config, traffic, seed, device, sync,
                        lambda scene, cam, rc: render(scene, cam, rc, mesh), mesh)
    scene, rc, cams, facts = su.scene, su.rc, su.cams, su.facts
    lap = len(cams)

    def one(k):
        return render(scene, cams[k % lap], rc, mesh)

    # what set-up made stays: the collector no longer walks it in the window
    gc.collect()
    gc.freeze()
    facts["setup_s"] = time.time() - t_start
    say("setup: " + ", ".join(f"{k} {v:.3f}" for k, v in facts.items()))
    facts["chips"] = mesh.size
    if lead:
        say(f"card state before the window: {hostinfo.card_state()}; host load average "
            f"{os.getloadavg()}")

    # every rank keeps its last frame at each checked view, rank 0's untimed
    # last frame included, so that all ranks keep the same window positions
    keep = set(su.checked)
    kept, frame_s, frame_end = {}, [], []
    read_s = 0.0
    begin = time.perf_counter()
    goal = begin + seconds
    i = 0
    while True:
        if lead:
            t0 = time.perf_counter()
            fr = one(i)
            sync()
            t1 = time.perf_counter()
            frame_s.append(t1 - t0)
            frame_end.append(t1 - begin)
            if t1 >= goal:
                stop.value = i + 1
        else:
            t0 = time.perf_counter()
            last = stop.value
            read_s += time.perf_counter() - t0
            if 0 <= last < i:
                break
            fr = one(i)
            sync()
        if i % lap in keep:
            kept[i % lap] = (i, fr)
        i += 1
        if lead and stop.value >= 0:
            fr = one(i)
            sync()
            if i % lap in keep:
                kept[i % lap] = (i, fr)
            i += 1
            break
    window_s = frame_end[-1] if lead else 0.0
    gc.unfreeze()
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    reads = everyone((read_s / max(i, 1), i))
    if lead:
        say(f"card state after the window: {hostinfo.card_state()}; host load average "
            f"{os.getloadavg()}")
        run_mod.log_window(frame_s, frame_end, window_s, log)
        say(f"frames rendered by each rank (the last untimed): {[k for _, k in reads]}; "
            f"reading the stop, us a frame by rank: "
            f"{[round(s * 1e6, 3) for s, _ in reads[1:]]}")

    tr = stage = None
    if traced:
        tr, named, traced_hits = run_mod.trace_after_window(torch, one, i, traffic, sync, cuda)
        hits = [int(h.sum()) for h in traced_hits]
        del traced_hits
        if cuda:
            # the stages, armed, over the loop's next frames on every rank
            after = i + int(traffic["trace_frames"]) + int(traffic["named_frames"])
            stage = stages.armed_run(torch, one, range(after, after + int(traffic["trace_frames"])),
                                     sync, cuda)
    traces = everyone(tr)
    readings = everyone(stage)
    peaks = everyone(memory_peak)
    digests = everyone({view: _digest(f.color, f.hit) for view, (_, f) in kept.items()})
    banned = sorted(set().union(*everyone(run_mod.banned_modules())))
    if not lead:
        return None

    if traced:
        facts.update(trace_facts(traces), traced_hit_pixels=hits)
        pace = facts["pacing_rank"]
        tr = traces[pace]
        say(f"traced {tr.frames} frames a rank; device seconds outside the all-gather by rank: "
            f"{[round(b, 6) for b in facts['band_busy_s']]}; busy by rank: "
            f"{[round(t.busy_s, 6) for t in traces]}; the gathers' transfer "
            f"{facts['gather_s']:.6f} s; the pacing rank is {pace}: {tr.kernels} kernels, "
            f"{len(tr.ops)} device ops, {tr.window_s:.4f} s, {tr.busy_s:.4f} s busy, "
            f"{facts['device_busy_s']:.4f} s without the gathers' spin; hit pixels a frame "
            f"{sum(hits) / len(hits):.0f} of {rc.width * rc.height}")
        stage = readings[pace]
        if stage is not None:
            say(f"stages of the pacing rank {pace}:\n{stages.table(stage)}")

    # the output check, once the program's state is freed
    outputs = {view: (pos, f.color, f.hit) for view, (pos, f) in kept.items()}
    differ = {view: sum(d.get(view) != digests[0][view] for d in digests[1:])
              for view in outputs}
    del scene, cams, kept, fr, one
    su.scene = su.cams = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    worst, bad = run_mod.check_outputs(outputs, su, config, len(frame_s), device, log)
    worst["rank_frames"] = max(differ.values(), default=0)
    bad |= {view for view, n in differ.items() if n}
    say(f"ranks whose frame differs from rank 0's, by checked view: {differ}")
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": mesh.size, "memory_peak_bytes": max(peaks)}
    if traced:
        dev.update(busy_s=sum(t.busy_s for t in traces) / len(traces),
                   window_s=sum(t.window_s for t in traces) / len(traces))
    ctx = run_mod.Ctx(frame_s=frame_s, window_s=window_s, facts=facts, trace=tr, config=config,
                      traffic=traffic)
    ctx.stage_reading = stage
    limits = {**config["check"]["limits"], "rank_frames": 0}
    return ctx, {"device": dev, "checked": bool(outputs), "failed": len(bad), "worst": worst,
                 "limits": limits, "banned": banned}
