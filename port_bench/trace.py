"""The traced sub-window: torch.profiler's Chrome trace, read back.

The harness wraps each traced frame in the span FRAME and the port's call
inside it in the span RENDER (`torch.profiler.record_function`), exports
the trace and hands its path to `read`. From the device's events (kernels,
copies, memsets), the runtime's and the host's, `read` gives a `Trace`:
the window, the device's busy time, each device op by a readable name,
the launches, the host's waits on the card inside the port's calls, and
every idle gap of the device named by the host code that ended it.

An idle gap ends when the host launches the next device op. It is named
by the innermost function of the port (a Python frame in
`hmrt_tpu_torch/`) running at that launch, from the profiler's stack
events (`with_stack=True`), as "kernels/compact.py:march_rounds"; where no
frame of the port runs then, by the innermost host op, and else "host".
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import re
from collections import defaultdict

FRAME = "port_bench.frame"
RENDER = "port_bench.render"
#: the port's own kernels (kernels/csrc), by the names they are launched under
PORT_KERNELS = ("march_pass_kernel", "shade_pass_kernel", "render_tile_kernel")
#: NCCL's all-gather kernels, by a part of their names
#: ("ncclDevKernel_AllGather_RING_LL", ...)
GATHER = "AllGather"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WAIT_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


@dataclasses.dataclass
class Trace:
    frames: int            # traced frames
    window_s: float        # first traced frame's start to the last one's end
    busy_s: float          # seconds of the window in which a device op ran
    ops: list              # (readable name, seconds) of each device op in the window
    kernels: int           # kernel launches in the window
    waits: int             # host waits on the card inside RENDER spans
    gaps: list             # (name, seconds) of each idle gap of the device

    def op_seconds(self, pick) -> float:
        """Device seconds of the ops whose readable name `pick` accepts."""
        return sum(s for name, s in self.ops if pick(name))

    def breakdown(self) -> dict:
        """The device ops that took most time and the idle gaps by what
        the host was doing, ten of each, summed by name."""
        def top(pairs):
            acc = defaultdict(float)
            for name, s in pairs:
                acc[name] += s
            return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(self.ops), "idle_gaps": top(self.gaps)}


def readable(name: str) -> str:
    """A device op's name without return type, namespaces or arguments:
    'void (anonymous namespace)::march_pass_kernel<false, 0>(Planes, ...)'
    -> 'march_pass_kernel<false, 0>'."""
    s = re.sub(r"\(anonymous namespace\)::|\b[A-Za-z_]\w*::", "", name)
    s = re.sub(r"^void ", "", s)
    depth = 0
    for i, ch in enumerate(s):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i:
            s = s[:i]
            break
    s = s.strip()
    return s if len(s) <= 96 else s[:95] + "…"


def _frame_name(py_name: str) -> str | None:
    """'.../hmrt_tpu_torch/kernels/compact.py(180): march_rounds' ->
    'kernels/compact.py:march_rounds'; None for a frame outside the port."""
    m = re.search(r"hmrt_tpu_torch/([\w/]+\.py)\(\d+\): (.+)$", py_name)
    return f"{m.group(1)}:{m.group(2)}" if m else None


def _innermost(spans, queries):
    """For each query time, the name of the innermost of the nested
    `spans` (start, end, name) that holds it, or None."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out = {}
    stack, i = [], 0
    for q in sorted(set(queries)):
        while i < len(spans) and spans[i][0] <= q:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < q:
            stack.pop()
        out[q] = stack[-1][2] if stack else None
    return out


def read(path: str) -> Trace:
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    frames = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == FRAME]
    if not frames:
        raise RuntimeError(f"the trace {path} holds no {FRAME} span")
    w0 = min(e["ts"] for e in frames)
    w1 = max(e["ts"] + e["dur"] for e in frames)
    main_tid = frames[0]["tid"]
    renders = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") == "user_annotation" and e.get("name") == RENDER)
    dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS
                  and w0 <= e["ts"] < w1), key=lambda e: e["ts"])
    ops = [(readable(e["name"]), e["dur"] * 1e-6) for e in dev]
    kernels = sum(e["cat"] == "kernel" for e in dev)
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver") and "args" in e
                 and "correlation" in e["args"]}
    starts = [r[0] for r in renders]

    def in_render(ts):
        k = bisect.bisect_right(starts, ts) - 1
        return k >= 0 and ts <= renders[k][1]

    waits = sum(1 for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("name") in WAIT_CALLS and w0 <= e["ts"] < w1 and in_render(e["ts"]))
    # merge the device's intervals; the gaps between them end at a launch
    busy, gaps_raw, end = 0.0, [], w0
    for e in dev:
        s, t = e["ts"], min(e["ts"] + e["dur"], w1)
        if s > end:
            gaps_raw.append((end, s, launch_ts.get(e.get("args", {}).get("correlation"), s)))
        if t > end:
            busy += t - max(s, end)
            end = t
    if w1 > end:
        gaps_raw.append((end, w1, None))
    py = [(e["ts"], e["ts"] + e["dur"], _frame_name(e["name"])) for e in events
          if e.get("cat") == "python_function" and e.get("tid") == main_tid]
    py = [s for s in py if s[2]]
    cpu = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
           if e.get("cat") == "cpu_op" and e.get("tid") == main_tid]
    queries = [g[2] for g in gaps_raw if g[2] is not None]
    by_py, by_op = _innermost(py, queries), _innermost(cpu, queries)
    gaps = [((by_py.get(q) or by_op.get(q) or "host") if q is not None else "window end",
             (b - a) * 1e-6) for a, b, q in gaps_raw]
    return Trace(frames=len(frames), window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6, ops=ops,
                 kernels=kernels, waits=waits, gaps=gaps)
