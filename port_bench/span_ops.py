"""Device time of the ops the port launches inside each of its spans.

`reading(ctx)`, called by a metric in a traced run on the card, renders
the loop's next `trace_frames` frames after `run.py`'s two traced
sub-runs (the same seeded lap and window positions that `stages.py`'s
sub-run takes) on the run's scene rebuilt from the configuration, under
torch.profiler with the port's tracing armed, so the frames run eagerly
and their launches sit in the port's spans. Each device op is charged to
every `hmrt.*` span that holds its launch (the runtime event with the op's
correlation id), so a span's time includes that of the spans inside it.
It returns None, and the metrics are left out, on a CPU run, where the
port has no `tracing`, or on a failure (its traceback goes to standard
error); a span that held no launch reads None.

`stages.py`'s sub-run renders the same frames armed, but its `Reading`
keeps only each stage's totals, not each span's; were `stages.read` to
keep each span's device seconds, one armed sub-run would serve both and
this module would go.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import traceback
from collections import defaultdict

from port_bench import stages
from port_bench import trace as trace_mod


@dataclasses.dataclass
class SpanOps:
    frames: int
    busy_s: dict  # span name -> device seconds of the ops launched inside it

    def ms(self, name: str) -> float | None:
        """Device ms a frame of the ops launched inside `name`, or None."""
        s = self.busy_s.get(name)
        return s / self.frames * 1e3 if s else None


def read(path: str) -> SpanOps:
    """The device seconds of each port span in the Chrome trace at `path`
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
             and e.get("name", "").startswith(stages.PREFIX)]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver") and "args" in e
                 and "correlation" in e["args"]}
    dev = [(launch_ts.get(e.get("args", {}).get("correlation")), e["dur"] * 1e-6)
           for e in events if e.get("cat") in trace_mod.DEVICE_CATS and w0 <= e["ts"] < w1]
    chains = stages._chains(spans, [q for q, _ in dev if q is not None])
    busy = defaultdict(float)
    for q, s in dev:
        for name in {sp[2] for sp in chains.get(q, ())}:
            busy[name] += s
    return SpanOps(frames=len(frames), busy_s=dict(busy))


def spans_run(ctx, device, seed: int, tracing, log=sys.stderr) -> SpanOps:
    """Rebuild the run's scene on `device`, render one warm-up frame armed
    and the loop's `trace_frames` frames after the two traced sub-runs
    under torch.profiler with `tracing` armed; returns their SpanOps."""
    import torch

    from hmrt_tpu_torch.api.scene import make_scene
    from hmrt_tpu_torch.config import RenderConfig
    from hmrt_tpu_torch.core.renderer import render_frame
    from hmrt_tpu_torch.types import Camera, Light
    from port_bench import paths, terrain

    config, traffic = ctx.config, ctx.traffic
    heights, albedo = terrain.make_inputs(config, device)
    heights_np = heights.cpu().numpy()
    albedo_np = None if albedo is None else albedo.cpu().numpy()
    del heights, albedo
    light = Light.create(**config["light"], device=device)
    scene = make_scene(heights_np, albedo=albedo_np, light=light, device=device)
    rc = RenderConfig(**config["render"])
    eyes, targets, _ = paths.seeded_lap(traffic, heights_np.shape[0],
                                        float(heights_np.max()), seed)
    first = int(traffic["trace_frames"])
    start = len(ctx.frame_s) + first + int(traffic["named_frames"])
    fov = float(traffic["fov_deg"])
    cams = [Camera.create(eye=tuple(eyes[k % len(eyes)]), target=tuple(targets[k % len(eyes)]),
                          fov_y_deg=fov, device=device) for k in range(start, start + first)]
    with tracing():
        render_frame(scene, cams[0], rc)
        torch.cuda.synchronize(device)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof, tracing():
        for cam in cams:
            with torch.profiler.record_function(trace_mod.FRAME):
                with torch.profiler.record_function(trace_mod.RENDER):
                    render_frame(scene, cam, rc)
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        got = read(path)
    finally:
        os.unlink(path)
    del scene, cams
    print(f"span ops sub-run: {got.frames} frames at window positions {start}-"
          f"{start + first - 1}; device ms a frame by span: "
          + ", ".join(f"{k} {v / got.frames * 1e3:.4f}" for k, v in sorted(got.busy_s.items())),
          file=log)
    return got


def reading(ctx) -> SpanOps | None:
    """The span ops of a traced run on the card, made once and kept on
    ctx; None on a CPU run, where the port has no `tracing`, or on a
    failure."""
    if hasattr(ctx, "span_ops"):
        return ctx.span_ops
    got = None
    try:
        device, tracing = stages.device_of(ctx), stages.port_tracing()
        if device is not None and tracing is not None:
            got = spans_run(ctx, device, stages.run_seed(), tracing)
    except Exception:  # a metric reader never raises: the metrics are left out
        traceback.print_exc(file=sys.stderr)
        got = None
    ctx.span_ops = got
    return got
