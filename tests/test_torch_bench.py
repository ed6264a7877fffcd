"""The port's bench runner, floor counts, CLI and trace hook on the CPU: the
row has the JAX row's keys, persists to --out, and the frame's march work
equals a plain WorkCounter march of the same rays."""

import dataclasses
import functools
import json
import os
from datetime import timedelta

import pytest
import torch
from torch.multiprocessing import ProcessRaisedException

import hmrt_tpu_torch as T
import hmrt_tpu_torch.kernels.compact as compact
from hmrt_tpu.bench.runner import run_bench as jax_run_bench
from hmrt_tpu.io.heightmap import procedural_terrain
from hmrt_tpu_torch.api.flythrough import frame_camera
from hmrt_tpu_torch.bench.configs import BENCH_CONFIGS
from hmrt_tpu_torch.bench.floor import bound, count_frame, count_lane_steps, floor_metrics
from hmrt_tpu_torch.bench.runner import ROW_KEYS, run_bench
from hmrt_tpu_torch.cli import bench as cli_bench
from hmrt_tpu_torch.distrib import mesh as dm
from hmrt_tpu_torch.kernels.compact import (empty_results, hit_points, init_state,
                                            primary_rays, shadow_start)
from hmrt_tpu_torch.kernels.march_pass import UNBUDGETED, march_pass, march_pass_reference
from hmrt_tpu_torch.kernels.shade_pass import shade_pass_reference
from hmrt_tpu_torch.traversal.march import WorkCounter
from hmrt_tpu_torch.utils.profiling import maybe_trace

torch.set_num_threads(2)  # the suite runs several workers at once

SMALL = dict(frames=2, scale=0.125, reps=1)


def test_b1_row_has_the_jax_rows_keys():
    row = run_bench("B1", **SMALL, device="cpu")
    want = jax_run_bench("B1", **SMALL)
    assert set(want) <= set(row), set(want) - set(row)
    assert set(want) == set(ROW_KEYS)
    assert row["config"] == "B1" and row["resolution"] == want["resolution"] == [64, 64]
    assert row["backend"] == row["device"] == "cpu" and row["chips"] == 1
    assert row["strategy"] == "single"
    assert row["ms_per_frame"] > 0 and row["frames"] == 2
    json.dumps(row)


def test_out_file_persists_row(tmp_path):
    out = tmp_path / "row.json"
    row = run_bench("B1", **SMALL, out_path=str(out), device="cpu")
    on_disk = json.loads(out.read_text())
    assert on_disk == json.loads(json.dumps(row))
    assert not (tmp_path / "row.json.tmp").exists()


def _bounded_spawn(monkeypatch):
    """Ranks the runner spawns get a 60 s process-group timeout and join
    limit, so a hang fails the test instead of the whole run."""
    monkeypatch.setattr(dm, "spawn", functools.partial(
        dm.spawn, timeout=timedelta(seconds=60), join_timeout=60))


def test_frame_sharded_raises(monkeypatch):
    """On a machine with 2 cards --frame-sharded starts 2 ranks, one per
    card; on a machine without a card the ranks raise, and a failed rank
    fails the run."""
    _bounded_spawn(monkeypatch)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ProcessRaisedException, match="CUDA device"):
        run_bench("B4", **SMALL, frame_sharded=True, device="cuda")


def test_sharded_config_on_several_cards_raises(monkeypatch):
    """B5 on 4 cards starts 4 ranks (band sharding over NCCL); without a
    card every rank raises, and so does the run."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(ProcessRaisedException, match="CUDA device"):
        run_bench("B5", **SMALL, device="cuda")


def _small(monkeypatch, name, **render):
    """Shrink a config's map (and frame) so its full-scale row runs on the CPU."""
    cfg = BENCH_CONFIGS[name]
    monkeypatch.setitem(BENCH_CONFIGS, name, dataclasses.replace(
        cfg, map_n=64, render=dataclasses.replace(cfg.render, **render)))


def test_frame_sharded_row_on_one_rank(monkeypatch):
    """--frame-sharded on one device runs the frame-parallel timing on a
    one-rank mesh: a "frame-dp" row of 1 chip, the group dropped after."""
    _small(monkeypatch, "B4")
    row = run_bench("B4", frames=3, scale=0.125, reps=1, frame_sharded=True, device="cpu")
    assert row["strategy"] == "frame-dp" and row["chips"] == 1 and row["frames"] == 3
    assert set(ROW_KEYS) <= set(row) and "ms_per_frame_1920x1080" not in row
    assert not torch.distributed.is_initialized()
    # a static config ignores it, as the JAX runner does
    assert run_bench("B1", **SMALL, frame_sharded=True, device="cpu")["strategy"] == "single"


def test_b5_one_device_row_carries_the_sharded_extras(monkeypatch):
    """B5 on one device: the unsharded row with the JAX note, plus
    sharded_mesh1_ms (render_frame_sharded on a one-rank group) and the
    band of H/8 rows at row0 4*H/8."""
    _small(monkeypatch, "B5", width=64, height=64)
    row = run_bench("B5", frames=1, reps=1, device="cpu")
    assert row["chips"] == 1 and row["strategy"] == "single" and "UNSHARDED" in row["note"]
    assert row["sharded_mesh1_ms"] > 0 and row["band_h8_ms"] > 0
    assert "sharded_mesh1_note" in row and "band_h8_note" in row
    assert not torch.distributed.is_initialized()
    jax_keys = {"sharded_mesh1_ms", "sharded_mesh1_note", "band_h8_ms", "band_h8_note"}
    assert jax_keys <= set(row)


def test_run_bench_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_bench("B1", **SMALL)


def test_cli_prints_one_json_row(capsys, tmp_path):
    out = tmp_path / "cli.json"
    cli_bench.main(["B1", "--cpu", "--scale", "0.125", "--frames", "2", "--reps", "1",
                    "--frame-sharded", "--out", str(out)])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert set(ROW_KEYS) <= set(row) and row["config"] == "B1"
    assert json.loads(out.read_text()) == row


def _floor_scene():
    terr = procedural_terrain(128, seed=3)
    scene = T.make_scene(terr, device="cpu")
    cam = T.Camera.create(eye=(64, -42, float(terr.max()) + 21),
                          target=(64, 64, float(terr.mean())), device="cpu")
    return scene, cam, T.RenderConfig(width=128, height=32, shading="phong", shadows=True)


def test_floor_metrics_equal_a_plain_work_counter():
    """Primary plus shadow steps make the total, and each equals one
    unbudgeted plain march of the same rays counted by WorkCounter: a ray's
    steps do not depend on the schedule."""
    scene, cam, cfg = _floor_scene()
    m = floor_metrics(scene, cam, cfg, measured_ms=100.0)
    assert m["lane_steps_per_frame"] == m["lane_steps_primary"] + m["lane_steps_shadow"]
    assert m["lane_steps_shadow"] > 0
    assert m["lane_steps_primary"] == sum(m["lane_steps_per_pass_primary"])
    assert m["lane_steps_shadow"] == sum(m["lane_steps_per_pass_shadow"])
    assert m["march_launches_per_frame"] == 5
    assert m["x_march_bound"] == pytest.approx(100.0 / m["march_bound_ms"])
    json.dumps(m)

    kw = dict(n=scene.n, m=scene.m, levels=scene.levels, budget=UNBUDGETED)
    rays = primary_rays(cam, cfg)
    p = rays[0].shape[0]
    prim = WorkCounter(scene.pyr_flat.shape[0], scene.n, "cpu")
    st = init_state(rays, None, scene.pyr_flat[-1], n=scene.n, m=scene.m, levels=scene.levels)
    _, (hit_i, t_hit, hx, hy) = march_pass_reference(rays, st, empty_results(p, "cpu"),
                                                     scene.pyr_flat, scene.heights,
                                                     counter=prim, **kw)
    hit = hit_i != 0
    points, fx, fy = hit_points(rays, hit, t_hit, hx, hy)
    normal = shade_pass_reference(hit_i, hx, hy, fx, fy, scene.shade_rec)[:3]
    srays, sstate = shadow_start(points, normal, hit, hx, hy, scene)
    shad = WorkCounter(scene.pyr_flat.shape[0], scene.n, "cpu")
    march_pass_reference(srays, sstate, empty_results(p, "cpu"), scene.pyr_flat,
                         scene.heights, counter=shad, **kw)
    assert m["lane_steps_primary"] == int(prim.steps)
    assert m["lane_steps_shadow"] == int(shad.steps)
    assert m["cell_tests_per_frame"] == int(prim.tests) + int(shad.tests)
    assert count_lane_steps(scene, cam, cfg)[0] == m["lane_steps_per_frame"]


def test_floor_metrics_of_an_animation_are_the_frame_means():
    scene, _, cfg = _floor_scene()
    cams = T.orbit_flythrough(128, float(scene.heights.max()), 2, device="cpu")
    m = floor_metrics(scene, cams, cfg, measured_ms=50.0)
    per = [floor_metrics(scene, frame_camera(cams, i), cfg) for i in range(2)]
    assert m["floor_frames"] == 2 and per[0]["floor_frames"] == 1
    for k in ("lane_steps_per_frame", "lane_steps_shadow", "march_bound_ms"):
        assert m[k] == pytest.approx((per[0][k] + per[1][k]) / 2), k
    assert m["lane_steps_per_pass_primary"] == pytest.approx(
        [(a + b) / 2 for a, b in zip(per[0]["lane_steps_per_pass_primary"],
                                     per[1]["lane_steps_per_pass_primary"])])
    assert m["x_march_bound"] == pytest.approx(50.0 / m["march_bound_ms"])
    assert per[0]["lane_steps_per_frame"] != per[1]["lane_steps_per_frame"]


def test_frame_counts_and_bound(monkeypatch):
    scene, cam, cfg = _floor_scene()
    live = []  # the lanes alive as each launch starts, read from its state

    def recording(rays, state, *a, **kw):
        live.append(int(torch.count_nonzero(state[0])))
        return march_pass(rays, state, *a, **kw)

    monkeypatch.setattr(compact, "march_pass", recording)
    fc = count_frame(scene, cam, cfg)
    assert fc.n_primary == 3 and len(fc.counts) == 5
    assert all(c.shape == (2, 128 * 32) and c.dtype == torch.int32 for c in fc.counts)
    ref = T.render_frame(scene, cam, cfg)
    assert torch.equal(fc.hit.reshape(32, 128), ref.hit)
    # a launch moves 24 planes of 4 bytes per live lane and 18 per dead one
    # (no ray planes); each step and test is 50 ops
    assert fc.live() == live and live[0] > 0 and max(live) < 128 * 32
    p = 128 * 32
    want = bound(sum(k * 96 + (p - k) * 72 for k in live),
                 (sum(fc.totals(0)) + sum(fc.totals(1))) * 50)
    ms, by = fc.bound()
    assert ms == pytest.approx(want[0]) and by == want[1]
    for k, n in enumerate(live):
        want = bound(n * 96 + (p - n) * 72, (fc.totals(0)[k] + fc.totals(1)[k]) * 50)
        ms, by = fc.launch_bound(k)
        assert ms == pytest.approx(want[0]) and by == want[1]


def test_bound_takes_the_larger_time():
    assert bound(3.35e12, 0) == (1e3, "bytes")
    assert bound(0, 67e12) == (1e3, "operations")


def test_maybe_trace_writes_a_chrome_trace(tmp_path):
    with maybe_trace(None) as prof:
        assert prof is None
    d = tmp_path / "trace"
    with maybe_trace(str(d)) as prof:
        torch.ones(64).cumsum(0)
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    doc = json.loads((d / files[0]).read_text())
    assert any("cumsum" in ev.get("name", "") for ev in doc["traceEvents"])
