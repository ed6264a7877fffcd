"""Profiling hook behind `--profile-dir`, and the port's stage spans.

Counterpart of `maybe_trace` in `hmrt_tpu/utils/profiling.py`, with
torch.profiler in place of jax.profiler. The JAX module's `compiled_cost`
and `flops_per_frame` read XLA's cost analysis of a jitted program; the
port compiles no such program, so they have no counterpart here.

Spans: the render path marks its stages with `span(name)` ("hmrt.frame",
"hmrt.raygen", "hmrt.primary", "hmrt.march.*", "hmrt.sort", ...; README,
"Stage spans"). While the port's tracing is armed (`tracing()`, or
`maybe_trace` with a directory) a span is a
`torch.profiler.record_function`, so it lands in the profiler's trace on
the same timeline as the device's kernels, and the device time and idle
gaps of a frame can be charged to the stage whose launches they follow.
Unarmed, `span` returns one shared no-op context: a bare
`record_function` costs about as much as a small torch op even with no
profiler listening, so the spans are gated, and arming is explicit (never
"a profiler is on"). Armed, the march kernel also counts the live lanes of
each launch (`kernels/march_pass.py`, `LaunchTally.read_live`).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

_NULL = contextlib.nullcontext()
_armed = 0
#: names of the port's spans open now, outermost first (armed only)
_open: list = []


class _Span:
    """An armed span: a record_function that also keeps `open_spans()`."""
    __slots__ = ("name", "args", "rf")

    def __init__(self, name: str, args: str | None):
        self.name, self.args, self.rf = name, args, None

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name, self.args)
        self.rf.__enter__()
        _open.append(self.name)
        return self

    def __exit__(self, *exc):
        _open.pop()
        self.rf.__exit__(*exc)
        return False


def span(name: str, args: str | None = None):
    """The stage span `name` (with `args`, a string the trace shows beside
    it) while tracing is armed, else the shared no-op context."""
    return _Span(name, args) if _armed else _NULL


def armed() -> bool:
    """Whether the port's tracing is armed (spans and live-lane counts)."""
    return _armed > 0


def open_spans() -> tuple:
    """The names of the port's spans open now, outermost first; () when
    tracing is not armed."""
    return tuple(_open)


@contextlib.contextmanager
def tracing():
    """Arm the port's spans and live-lane counts over the body (nests)."""
    global _armed
    _armed += 1
    try:
        yield
    finally:
        _armed -= 1


@contextlib.contextmanager
def maybe_trace(profile_dir: str | None):
    """torch.profiler over the body when profile_dir is set, else a no-op.

    Records CPU activity, and CUDA activity when a card is present, with
    the port's tracing armed, and writes a Chrome trace
    (`chrome://tracing`, Perfetto) into profile_dir when the body ends.
    Yields the profiler, or None."""
    if not profile_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof, tracing():
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"hmrt_trace_{os.getpid()}_{time.time_ns()}.json"))
