"""The stage reading of the port's spans (stages.py): a hand-built trace
charged op by op and gap by gap, the metric readers on it, and the tiny
CPU bench, correct with the stage metrics left out, with and without the
port's `tracing`."""

import json
import sys
import types

import pytest
import torch

from port_bench import cells, run, stages
from port_bench.tests.conftest import HERE, tiny_bench
from port_bench.trace import FRAME, RENDER

NEW = ("raygen_ms", "march_ms", "sort_ms", "shadow_ms", "shade_ms", "live_lane_pct")


def _span(name, ts, end, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": end - ts,
            "pid": 1, "tid": tid}


def _launch(ts, corr, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 5, "pid": 1,
            "tid": 1, "args": {"correlation": corr}}


def _kernel(ts, end, corr):
    return {"ph": "X", "cat": "kernel", "name": f"void k{corr}(int)", "ts": ts,
            "dur": end - ts, "pid": 0, "tid": 7, "args": {"correlation": corr}}


def _trace(tmp_path):
    """One frame of 1000 us: raygen launches k1 and k2, pass 0 of the
    primary march k3, a sort k4; a wait in the primary march outside its
    pass, and the harness's synchronise after the port's frame."""
    events = [_span(FRAME, 0, 1000), _span(RENDER, 0, 900), _span("hmrt.frame", 10, 880),
              _span("hmrt.raygen", 20, 200), _span("hmrt.primary", 200, 860),
              _span("hmrt.march.pass0", 300, 500), _span("hmrt.sort", 600, 700),
              _launch(50, 1), _launch(150, 2), _launch(400, 3), _launch(650, 4),
              _launch(210, 99, "cudaStreamSynchronize"),
              _launch(890, 98, "cudaDeviceSynchronize"),
              _kernel(100, 160, 1), _kernel(160, 250, 2), _kernel(450, 600, 3),
              _kernel(700, 720, 4)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_each_op_and_gap_is_charged_to_its_stage(tmp_path):
    r = stages.read(_trace(tmp_path))
    us = {k: ((s.busy_s * 1e6, s.idle_s * 1e6), s.launches, s.waits)
          for k, s in r.stages.items()}
    # gap [0, 100) ends at k1, launched in raygen at 50: raygen's share is
    # the host's time in hmrt.frame (from 10) before that launch, the rest
    # the harness's
    assert us["raygen"] == (pytest.approx((150.0, 40.0)), 2, 0)
    assert us["primary march"] == (pytest.approx((150.0, 200.0)), 1, 1)
    assert us["primary sort"] == (pytest.approx((20.0, 100.0)), 1, 0)
    assert us[stages.UNATTRIBUTED] == (pytest.approx((0.0, 340.0)), 0, 1)
    assert r.frames == 1 and r.window_s == pytest.approx(1e-3) and r.device_ops == 4
    total = sum(s.busy_s + s.idle_s for s in r.stages.values())
    assert total == pytest.approx(r.window_s)
    host = {k: s.host_s * 1e6 for k, s in r.stages.items()}
    assert host == pytest.approx({"frame": 30.0, "raygen": 180.0, "primary march": 560.0,
                                  "primary sort": 100.0, stages.UNATTRIBUTED: 130.0})
    assert r.ms("raygen") == pytest.approx(0.19)
    assert r.ms("primary sort", "shadow sort") == pytest.approx(0.12)
    assert r.ms("shade") is None and r.live_pct() is None
    assert "unattributed 0.3400 ms" in stages.table(r)
    assert r.lead_us == (10, 50)


def test_the_count_keeps_only_its_own_time(tmp_path):
    """A march span's checks run before its count, the count's launch ends
    the gap: the count keeps the host's time in its own span, the march
    the rest."""
    events = [_span(FRAME, 0, 1000), _span("hmrt.frame", 10, 900),
              _span("hmrt.primary", 20, 800), _span("hmrt.march.pass0", 100, 500),
              _span("hmrt.count", 300, 340), _launch(320, 5), _launch(400, 6),
              _kernel(330, 335, 5), _kernel(410, 600, 6)]
    path = tmp_path / "count.json"
    path.write_text(json.dumps({"traceEvents": events}))
    r = stages.read(str(path))
    us = {k: (round(s.busy_s * 1e6, 6), round(s.idle_s * 1e6, 6)) for k, s in r.stages.items()
          if s.busy_s or s.idle_s}
    assert us == {"count": (5.0, 20.0), "primary march": (190.0, 365.0),
                  stages.UNATTRIBUTED: (0.0, 420.0)}
    assert r.ms("primary march") == pytest.approx(0.555)


def test_stage_of_a_chain():
    f, p, sh = "hmrt.frame", "hmrt.primary", "hmrt.shadow"
    assert stages.stage_of(()) == stages.stage_of(("port_bench.frame",)) == "unattributed"
    assert stages.stage_of((f, "hmrt.raygen")) == "raygen"
    assert stages.stage_of((f, p, "hmrt.march.tail")) == "primary march"
    assert stages.stage_of((f, p, "hmrt.unsort")) == "primary sort"
    assert stages.stage_of((f, "hmrt.shade", sh, "hmrt.sort")) == "shadow sort"
    assert stages.stage_of((f, "hmrt.shade", sh, "hmrt.march.round")) == "shadow march"
    assert stages.stage_of((f, "hmrt.shade")) == "shade"
    assert stages.stage_of((f,)) == "frame"
    assert stages.stage_of((f, "hmrt.fused.kernel")) == "fused.kernel"


def test_the_metric_readers_on_a_reading(tmp_path):
    r = stages.read(_trace(tmp_path))
    stages.add_live(r, [(("hmrt.frame", "hmrt.primary", "hmrt.march.pass0"), 30, 100),
                        (("hmrt.frame", "hmrt.shade", "hmrt.shadow", "hmrt.march.tail"), 10, 100)])
    ctx = types.SimpleNamespace(stage_reading=r)
    got = {m: cells.load_reader(HERE / "metrics" / f"{m}.py")(ctx) for m in NEW}
    assert got["shade_ms"] is None  # a stage neither traced nor counted
    assert [got[m] for m in ("raygen_ms", "march_ms", "sort_ms", "shadow_ms", "live_lane_pct")] \
        == pytest.approx([0.19, 0.35, 0.12, 0.0, 20.0])
    assert stages.reading(types.SimpleNamespace(stage_reading=None)) is None


def test_run_seed_from_the_command_line():
    assert stages.run_seed(["run.py", "--workload", "B3.flyover", "--seed", "2147483999"]) \
        == 2147483999
    assert stages.run_seed(["run.py", "--seed=7"]) == 7
    assert stages.run_seed(["pytest"]) == 0


def _tiny_with_stages(tmp_path, backend):
    """The tiny bench with the stage metrics applying to its cell and the
    configuration on `backend`."""
    bench = tiny_bench(tmp_path)
    b = json.loads(bench.read_text())
    for m in b["per_layer"]:
        if m["name"] in NEW:
            m["workloads"] = ["T.t"]
    bench.write_text(json.dumps(b))
    cfg = json.loads((tmp_path / "configs" / "T.json").read_text())
    cfg["render"]["backend"] = backend
    (tmp_path / "configs" / "T.json").write_text(json.dumps(cfg))
    return cells.resolve("T.t", bench, tmp_path)


def test_tiny_cpu_bench_is_correct_with_the_stage_metrics_left_out(tmp_path):
    cell = _tiny_with_stages(tmp_path, "compact")
    out = run.run_cell(cell, 2**31 + 21, 1.0, True, torch.device("cpu"), sys.stderr)
    assert out["correct"] is True
    assert not set(NEW) & set(out["metrics"])  # a CPU run: no device, no stages


@pytest.mark.parametrize("port_has_tracing", [True, False])
def test_spans_sub_run_on_the_cpu(tmp_path, monkeypatch, port_has_tracing):
    """The third sub-run forced onto the CPU: with the port's tracing the
    spans and counts are read (no device op, so no stage ms); without it
    (an older port) nothing is rendered and every stage metric is left
    out. The run is correct either way."""
    cell = _tiny_with_stages(tmp_path, "compact")
    monkeypatch.setattr(stages, "device_of", lambda ctx: torch.device("cpu"))
    if not port_has_tracing:
        import hmrt_tpu_torch.utils.profiling as prof
        monkeypatch.delattr(prof, "tracing")
    seen = []
    real = stages.spans_run

    def spans_run(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]

    monkeypatch.setattr(stages, "spans_run", spans_run)
    out = run.run_cell(cell, 2**31 + 5, 1.0, True, torch.device("cpu"), sys.stderr)
    assert out["correct"] is True
    m = out["metrics"]
    assert not {"raygen_ms", "march_ms", "sort_ms", "shadow_ms", "shade_ms"} & set(m)
    if port_has_tracing:
        (r,) = seen
        assert r.frames == cell.traffic["trace_frames"]
        assert {"raygen", "primary march", "primary sort", "shadow march", "shadow sort",
                "shade"} <= set(r.stages)
        assert sum(s.lanes for s in r.stages.values()) == 5 * r.frames * 48 * 32
        assert 0.0 < m["live_lane_pct"]["value"] <= 100.0
    else:
        assert seen == [] and "live_lane_pct" not in m
