"""The frame charged stage by stage, from the port's own spans.

The port marks the stages of a frame with spans (`hmrt.frame`,
`hmrt.raygen`, `hmrt.primary`, `hmrt.march.*`, `hmrt.sort`,
`hmrt.unsort`, `hmrt.shade`, `hmrt.shadow`: torch.profiler's
`record_function`, recorded only while the port's tracing is armed,
`hmrt_tpu_torch/utils/profiling.py::tracing`), and while armed its march
counts the live lanes of each launch (`march_pass.mode_launches`,
`read_live`: a reduction in the span `hmrt.count` before each launch).
The two traced sub-runs of `run.py` stay unarmed; this module makes a
third, for the per-layer metrics that read the stages.

`reading(ctx)`, called by the first of those metrics in a traced run on
the card, rebuilds the run's scene from the configuration, renders the
loop's next `trace_frames` frames after the two sub-runs (the same seeded
lap, the same window positions) once more under torch.profiler, with no
stacks and the port's tracing armed (`armed_run`), reads the trace back
with `read` and the tally's live-lane counts, prints a table of the
stages to standard error and keeps the result on `ctx` for the other
metrics. It returns None, and the metrics are left out, on a CPU run and
where the port has no `tracing` (an older port): then it renders nothing.
A run over several cards (sharded.py) makes the armed sub-run on every
rank with its own scene and puts the pacing rank's reading on `ctx`.

`read` charges each device op to the stage of the `hmrt.*` spans that
hold its launch (the runtime event with the op's correlation id), and
each idle gap of the device to the stage of the launch that ends it, for
as long as the launch's `hmrt.frame` (on a rank of a mesh, `hmrt.band`)
had run on the host before it: the part of the first gap of a frame
before that is the harness's. (Only host
times are compared with host times: the device's timestamps in the
trace can sit a millisecond or two off the host's, `Reading.lead_us`.)
Stages: the live-lane count (`hmrt.count`) is "count", charged to no
stage of the frame (its ops, and of the gap its launch ends only the
host's time inside the count: the march's checks before it are the
march's); charges under `hmrt.sort` or `hmrt.unsort` go to the
sort of their march ("primary sort", "shadow sort"); others under
`hmrt.shadow` to "shadow march", under `hmrt.primary` to "primary march";
then "raygen" and "shade"; any other span gives its own name ("frame",
"fused.params", ...). What is left ("unattributed") is the harness's own
time between frames, its synchronise included, and any op launched
outside the port's spans. Busy and idle time of all stages, the count
and the rest sum to the window.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import sys
import tempfile
import traceback
from collections import defaultdict

from port_bench import trace as trace_mod

PREFIX = "hmrt."
UNATTRIBUTED = "unattributed"
#: the live-lane count's span and stage (hmrt_tpu_torch/kernels/march_pass.py)
COUNT = "hmrt.count"
#: the port's spans around one frame's work on its card: a whole frame, or
#: a rank's band of one (distrib/mesh.py::render_band; its gathers follow
#: outside it)
FRAME_SPANS = ("hmrt.frame", "hmrt.band")
#: the stages the per-layer metrics read, in frame order
STAGES = ("raygen", "primary march", "primary sort", "shadow march", "shadow sort", "shade")


@dataclasses.dataclass
class Stage:
    host_s: float = 0.0   # host time in the stage's spans, their children's excluded
    busy_s: float = 0.0   # device time of the ops it launched
    idle_s: float = 0.0   # device idle time that ended at its launches
    launches: int = 0     # device kernels it launched
    waits: int = 0        # host waits on the card inside it
    live: int = 0         # live lanes into its march kernel launches (the port's tally)
    lanes: int = 0        # lanes launched into them


@dataclasses.dataclass
class Reading:
    frames: int
    window_s: float
    stages: dict          # stage name -> Stage
    device_ops: int       # device ops in the window
    rest: list = dataclasses.field(default_factory=list)  # longest unattributed gaps
    lead_us: tuple = ()   # a kernel's start less its launch: (least, median) us

    def ms(self, *names) -> float | None:
        """Device ms a frame (busy and idle) charged to `names`, or None
        when none of them was seen or no device op ran."""
        got = [self.stages[n] for n in names if n in self.stages]
        if not got or not self.device_ops:
            return None
        return sum(s.busy_s + s.idle_s for s in got) / self.frames * 1e3

    def live_pct(self) -> float | None:
        """Live lanes over lanes launched into the march kernel, in %."""
        lanes = sum(s.lanes for s in self.stages.values())
        return sum(s.live for s in self.stages.values()) / lanes * 100.0 if lanes else None


def stage_of(chain) -> str:
    """The stage of a launch (or a wait, or a span) from the names of the
    spans that hold it, outermost first."""
    names = [n for n in chain if n.startswith(PREFIX)]
    if not names:
        return UNATTRIBUTED
    held = set(names)
    if COUNT in held:
        return "count"
    if held & {"hmrt.sort", "hmrt.unsort"}:
        return "shadow sort" if "hmrt.shadow" in held else "primary sort"
    for span, stage in (("hmrt.shadow", "shadow march"), ("hmrt.primary", "primary march"),
                        ("hmrt.raygen", "raygen"), ("hmrt.shade", "shade")):
        if span in held:
            return stage
    return names[-1][len(PREFIX):]


def _chains(spans, queries) -> dict:
    """For each query time, the nested `spans` (start, end, name) that
    hold it, outermost first."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = {}, [], 0
    for q in sorted(set(queries)):
        while i < len(spans) and spans[i][0] <= q:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < q:
            stack.pop()
        out[q] = tuple(stack)
    return out


def _exclusive(spans) -> list:
    """(start, name chain, seconds) of each of the nested `spans`, less
    the time its children take."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack = [], []  # stack: [start, end, chain, child seconds]
    for s, e, name in spans:
        while stack and stack[-1][1] <= s:
            a = stack.pop()
            out.append((a[0], a[2], a[1] - a[0] - a[3]))
        chain = (stack[-1][2] if stack else ()) + (name,)
        if stack:
            stack[-1][3] += e - s
        stack.append([s, e, chain, 0.0])
    out.extend((a[0], a[2], a[1] - a[0] - a[3]) for a in stack)
    return out


def read(path: str) -> Reading:
    """The stages of the traced window in the Chrome trace at `path`
    (the harness's FRAME spans around the port's calls)."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    frames = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") == trace_mod.FRAME]
    if not frames:
        raise RuntimeError(f"the trace {path} holds no {trace_mod.FRAME} span")
    w0 = min(e["ts"] for e in frames)
    w1 = max(e["ts"] + e["dur"] for e in frames)
    tid = frames[0]["tid"]
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("tid") == tid
             and e.get("name", "").startswith(PREFIX)]
    port_frames = sorted((s, t) for s, t, name in spans if name in FRAME_SPANS)
    frame_starts = [s for s, _ in port_frames]
    dev = sorted((e for e in events if e.get("cat") in trace_mod.DEVICE_CATS
                  and w0 <= e["ts"] < w1), key=lambda e: e["ts"])
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver") and "args" in e
                 and "correlation" in e["args"]}
    waits = [e["ts"] for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and e.get("name") in trace_mod.WAIT_CALLS and e.get("tid") == tid
             and w0 <= e["ts"] < w1]
    launches = [launch_ts.get(e.get("args", {}).get("correlation")) for e in dev]
    chains = _chains(spans, [q for q in launches if q is not None] + waits)
    rest = []  # (us, gap start, ending op, launch time) of each unattributed part
    stages = defaultdict(Stage)

    def names(q):
        return tuple(sp[2] for sp in chains.get(q, ()))

    def stage(q):
        return UNATTRIBUTED if q is None else stage_of(names(q))

    def frame_share(gap, q):
        """The part of an idle gap of `gap` us, ended by the launch at host
        time q, that the launch's frame took on the host before it: at most
        q less the start of the hmrt.frame span that holds q (both on the
        host's clock, so an offset of the device's clock moves nothing)."""
        if q is None:
            return 0.0
        k = bisect.bisect_right(frame_starts, q) - 1
        if k < 0 or q > port_frames[k][1]:
            return 0.0
        return min(gap, q - port_frames[k][0])

    end = w0
    for e, q in zip(dev, launches):
        st = stages[stage(q)]
        st.launches += e["cat"] == "kernel"
        s, t = e["ts"], min(e["ts"] + e["dur"], w1)
        if s > end:
            gap = s - end
            charged = frame_share(gap, q)
            if gap > charged:
                stages[UNATTRIBUTED].idle_s += (gap - charged) * 1e-6
                rest.append((gap - charged, end, e, q))
            if names(q)[-1:] == (COUNT,):
                # the count is the first launch of a march span: of the gap
                # it ends, only the host's time in the count is its own, the
                # rest is the march's (its checks before the count)
                own = min(charged, q - chains[q][-1][0])
                stages[stage_of(names(q)[:-1])].idle_s += (charged - own) * 1e-6
                charged = own
            st.idle_s += charged * 1e-6
        if t > end:
            st.busy_s += (t - max(s, end)) * 1e-6
            end = t
    if w1 > end:
        stages[UNATTRIBUTED].idle_s += (w1 - end) * 1e-6
        rest.append((w1 - end, end, None, None))
    for q in waits:
        stages[stage(q)].waits += 1
    in_window = [sp for sp in spans if w0 <= sp[0] < w1]
    for _, chain, us in _exclusive(in_window):
        stages[stage_of(chain)].host_s += us * 1e-6
    host = sum(s.host_s for name, s in stages.items() if name != UNATTRIBUTED)
    stages[UNATTRIBUTED].host_s = (w1 - w0) * 1e-6 - host
    lead = sorted(e["ts"] - q for e, q in zip(dev, launches)
                  if q is not None and e["cat"] == "kernel")
    rest = sorted(rest, key=lambda r: -r[0])[:5]
    at = _chains(spans, [r[1] for r in rest])
    rest = [(us * 1e-6, "/".join(sp[2] for sp in at[a]) or "outside the port's spans",
             trace_mod.readable(e["name"]) if e else "the window's end",
             "/".join(names(q)) if q else "no launch")
            for us, a, e, q in rest]
    return Reading(frames=len(frames), window_s=(w1 - w0) * 1e-6, stages=dict(stages),
                   device_ops=len(dev), rest=rest,
                   lead_us=(lead[0], lead[len(lead) // 2]) if lead else ())


def add_live(reading: Reading, records) -> None:
    """Add the tally's (spans, live lanes, lanes launched) records to the
    stages that launched them."""
    for chain, live, lanes in records:
        st = reading.stages.setdefault(stage_of(chain), Stage())
        st.live += live
        st.lanes += lanes


def table(reading: Reading) -> str:
    """The stages a frame, in frame order, then the rest."""
    f = reading.frames
    names = [n for n in STAGES if n in reading.stages]
    names += sorted(set(reading.stages) - set(STAGES) - {UNATTRIBUTED})
    names += [UNATTRIBUTED] if UNATTRIBUTED in reading.stages else []
    rows = [f"{'stage (a frame)':<16} {'host ms':>8} {'busy ms':>8} {'idle ms':>8} "
            f"{'launches':>8} {'waits':>6}  live / lanes"]
    for n in names:
        s = reading.stages[n]
        live = f"{s.live / f:,.0f} / {s.lanes / f:,.0f}" if s.lanes else "-"
        rows.append(f"{n:<16} {s.host_s / f * 1e3:8.3f} {s.busy_s / f * 1e3:8.3f} "
                    f"{s.idle_s / f * 1e3:8.3f} {s.launches / f:8.1f} {s.waits / f:6.1f}  "
                    f"{live}")

    def ms(keep):
        return sum(s.busy_s + s.idle_s for n, s in reading.stages.items() if keep(n)) / f * 1e3

    total, five = ms(lambda n: True), ms(lambda n: n in STAGES)
    rest = total - five
    rows.append(f"charged {total:.4f} ms of a {reading.window_s / f * 1e3:.4f} ms frame: the "
                f"stages {five:.4f} ms, the rest {rest:.4f} ms ({rest / total * 100:.2f}%; "
                f"unattributed {ms(lambda n: n == UNATTRIBUTED):.4f} ms, the count "
                f"{ms(lambda n: n == 'count'):.4f} ms)")
    rows += [f"  unattributed gap {s * 1e3:.4f} ms: the host in {at}, ended by {op} ({by})"
             for s, at, op, by in reading.rest]
    if reading.lead_us:
        rows.append("a kernel's start less its launch: least {:.1f} us, median {:.1f} us"
                    .format(*reading.lead_us))
    return "\n".join(rows)


def port_tracing():
    """The port's `tracing` context, or None for a port without one."""
    try:
        from hmrt_tpu_torch.utils.profiling import tracing
    except ImportError:
        return None
    return tracing


def _read_live():
    """The port's tally reader of live lanes, or None."""
    try:
        from hmrt_tpu_torch.kernels.march_pass import march_pass
    except ImportError:
        return None
    return getattr(getattr(march_pass, "mode_launches", None), "read_live", None)


def run_seed(argv=None) -> int:
    """The run's --seed from the command line (0 where there is none)."""
    argv = sys.argv if argv is None else argv
    for k, a in enumerate(argv):
        if a == "--seed" and k + 1 < len(argv):
            return int(argv[k + 1])
        if a.startswith("--seed="):
            return int(a.split("=", 1)[1])
    return 0


def device_of(ctx):
    """The card a traced run ran on, or None for a CPU run."""
    import torch
    t = ctx.trace
    if t is None or not t.kernels or not torch.cuda.is_available():
        return None
    return torch.device("cuda", 0)


def armed_run(torch, render_one, frames, sync, cuda: bool, log=sys.stderr) -> Reading | None:
    """Render `frames` (window positions), each by `render_one(position)`,
    under torch.profiler with the port's tracing armed, after one warm-up
    frame armed (the scene's buffers and the tally's slots); returns their
    Reading with the live lanes of their launches, or None for a port
    without `tracing`."""
    import numpy as np

    tracing, read_live = port_tracing(), _read_live()
    if tracing is None:
        return None
    with tracing():
        render_one(frames[0])
        sync()
    if read_live is not None:
        read_live()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof, tracing():
        for k in frames:
            with torch.profiler.record_function(trace_mod.FRAME):
                with torch.profiler.record_function(trace_mod.RENDER):
                    render_one(k)
                sync()
    records = read_live() if read_live is not None else []
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        got = read(path)
    finally:
        os.unlink(path)
    add_live(got, records)
    print(f"spans sub-run: {got.frames} frames, window {got.window_s:.4f} s, "
          f"{got.device_ops} device ops, {len(records)} march launches counted, "
          f"frames at window positions {frames[0]}-{frames[-1]}, "
          f"{np.mean([r[1] for r in records]) if records else 0:.0f} live lanes a launch",
          file=log)
    return got


def spans_run(ctx, device, seed: int, log=sys.stderr) -> Reading | None:
    """Rebuild the run's scene on `device` and render the loop's next
    `trace_frames` frames after the two traced sub-runs with the port's
    tracing armed (`armed_run`)."""
    import torch

    from hmrt_tpu_torch.api.scene import make_scene
    from hmrt_tpu_torch.config import RenderConfig
    from hmrt_tpu_torch.core.renderer import render_frame
    from hmrt_tpu_torch.types import Camera, Light
    from port_bench import paths, terrain

    config, traffic = ctx.config, ctx.traffic
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    heights, albedo = terrain.make_inputs(config, device)
    heights_np = heights.cpu().numpy()
    albedo_np = None if albedo is None else albedo.cpu().numpy()
    del heights, albedo
    rc = RenderConfig(**config["render"])
    light = Light.create(**config["light"], device=device)
    scene = make_scene(heights_np, albedo=albedo_np, light=light, device=device)
    eyes, targets, _ = paths.seeded_lap(traffic, heights_np.shape[0],
                                        float(heights_np.max()), seed)
    first = int(traffic["trace_frames"])
    start = len(ctx.frame_s) + first + int(traffic["named_frames"])
    fov = float(traffic["fov_deg"])
    cams = {k: Camera.create(eye=tuple(eyes[k % len(eyes)]), target=tuple(targets[k % len(eyes)]),
                             fov_y_deg=fov, device=device) for k in range(start, start + first)}
    got = armed_run(torch, lambda k: render_frame(scene, cams[k], rc),
                    range(start, start + first), sync, cuda, log)
    del scene, cams
    return got


def reading(ctx) -> Reading | None:
    """The stages of a traced run on the card, made once and kept on ctx;
    None on a CPU run, where the port has no `tracing`, or on a failure
    (its traceback goes to standard error)."""
    if hasattr(ctx, "stage_reading"):
        return ctx.stage_reading
    got = None
    try:
        device = device_of(ctx)
        if device is not None and port_tracing() is not None:
            got = spans_run(ctx, device, run_seed())
        if got is not None:
            print(table(got), file=sys.stderr)
    except Exception:  # a metric reader never raises: the metrics are left out
        traceback.print_exc(file=sys.stderr)
        got = None
    ctx.stage_reading = got
    return got
