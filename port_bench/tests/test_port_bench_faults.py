"""The output check catches a broken timed path: a run is driven end to
end on the CPU (the look for a card skipped) with the port's entry broken
underneath, and `correct` comes out false for each fault a cell can have.
A one-card cell has no exchange between chips to leave out."""

import dataclasses
import sys

import pytest
import torch

from port_bench import cells, run
from port_bench.tests.conftest import tiny_bench


def _port():
    from hmrt_tpu_torch.core.renderer import render_frame
    return render_frame


def stale(render):
    """A step that returns its state unchanged: the first frame, every time."""
    first = []

    def f(scene, cam, cfg):
        if not first:
            first.append(render(scene, cam, cfg))
        return first[0]
    return f


def half(render):
    """Half of the batch left out: the lower half of the rows never rendered."""
    def f(scene, cam, cfg):
        fr = render(scene, cam, cfg)
        h = cfg.height // 2
        color, hit = fr.color.clone(), fr.hit.clone()
        color[h:], hit[h:] = 0.0, False
        return dataclasses.replace(fr, color=color, hit=hit)
    return f


def altered(render):
    """An answer altered where it is produced: the frame's colour shifted."""
    def f(scene, cam, cfg):
        fr = render(scene, cam, cfg)
        return dataclasses.replace(fr, color=torch.clamp(fr.color + 0.02, 0.0, 0.99))
    return f


def late(render, after: int):
    """A path switched after `after` calls: every later frame's colour
    shifted, as a buffer reused across laps would show."""
    calls = []

    def f(scene, cam, cfg):
        fr = render(scene, cam, cfg)
        calls.append(None)
        if len(calls) <= after:
            return fr
        return dataclasses.replace(fr, color=torch.clamp(fr.color + 0.02, 0.0, 0.99))
    return f


@pytest.mark.parametrize("config,traffic", [("B3", "flyover"), ("B4", "orbit")])
@pytest.mark.parametrize("fault", [None, stale, half, altered])
def test_fault_makes_the_run_incorrect(tmp_path, config, traffic, fault):
    bench = tiny_bench(tmp_path, config, traffic, n=129, size=(160, 90))
    cell = cells.resolve("T.t", bench, tmp_path)
    entry = _port() if fault is None else fault(_port())
    out = run.run_cell(cell, 11, 1.0, False, torch.device("cpu"), sys.stderr, render_frame=entry)
    assert out["correct"] is (fault is None), out["checks"]
    assert (out["failed"] == 0) is (fault is None)


@pytest.mark.parametrize("config,traffic", [("B3", "flyover"), ("B4", "orbit")])
def test_a_fault_after_the_first_lap_makes_the_run_incorrect(tmp_path, config, traffic):
    """The check judges the window's end, not its start: a fault that
    begins once the window's first lap is done is caught."""
    bench = tiny_bench(tmp_path, config, traffic)
    cell = cells.resolve("T.t", bench, tmp_path)
    tr = cell.traffic
    lap, warm, span = tr["frames_per_lap"], tr["warmup_frames"], tr["check_span"]
    entry = late(_port(), warm + lap)
    out = run.run_cell(cell, 11, 3.0, False, torch.device("cpu"), sys.stderr, render_frame=entry)
    assert out["attempted"] > lap + span, "the window never reached its second lap's views"
    assert out["correct"] is False and out["failed"] == tr["check_frames"], out["checks"]
