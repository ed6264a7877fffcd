"""Profiling hook behind `--profile-dir`.

Counterpart of `maybe_trace` in `hmrt_tpu/utils/profiling.py`, with
torch.profiler in place of jax.profiler. The JAX module's `compiled_cost`
and `flops_per_frame` read XLA's cost analysis of a jitted program; the
port compiles no such program, so they have no counterpart here.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def maybe_trace(profile_dir: str | None):
    """torch.profiler over the body when profile_dir is set, else a no-op.

    Records CPU activity, and CUDA activity when a card is present, and
    writes a Chrome trace (`chrome://tracing`, Perfetto) into profile_dir
    when the body ends. Yields the profiler, or None."""
    if not profile_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"hmrt_trace_{os.getpid()}_{time.time_ns()}.json"))
