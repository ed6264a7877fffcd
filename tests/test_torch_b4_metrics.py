"""The benchmark's readers for B4.orbit's shade metrics, on the CPU: the
shade pass's byte count on the shapes of the bring-up table, and that
`fog_ms`, `shade_kernel_ms` and `shade_kernel_roofline` read nothing, and
so are left out, on a run without a card."""

import json
import sys

import pytest
import torch

from port_bench import cells, run
from port_bench.kernel_bytes import shade_pass_bytes
from port_bench.roofline import HBM_BYTES_PER_S
from port_bench.tests.conftest import tiny_bench

METRICS = ("fog_ms", "shade_kernel_ms", "shade_kernel_roofline")


def test_shade_pass_bytes_counts_lanes_and_records():
    assert shade_pass_bytes(1, 0, True) == 44
    assert shade_pass_bytes(1, 1, False) == 44 + 32
    assert shade_pass_bytes(10, 4, True) == 10 * 44 + 4 * (32 + 48)


@pytest.mark.parametrize("lanes, textured, table_ms, hit_share", [
    (2_073_600, False, 0.0313, None),  # B3, 1920x1080
    (921_600, True, 0.0274, 0.72),     # B4, 1280x720, ~72% of pixels hit
])
def test_shade_pass_bytes_against_the_bring_up_table(lanes, textured, table_ms, hit_share):
    """The bring-up table bounds K2 by the distinct corner samples its hits
    read, which neighbouring hits share; this count charges each hit its
    records, so it reads at least the table's bound at the same hits, and
    on B4, whose hits at 8192² seldom share a cell, within 5% of it."""
    def least_ms(hits):
        return shade_pass_bytes(lanes, hits, textured) / HBM_BYTES_PER_S * 1e3

    assert least_ms(0) < table_ms < least_ms(lanes)
    if hit_share is not None:
        assert least_ms(hit_share * lanes) == pytest.approx(table_ms, rel=0.05)


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench")
    bench = tiny_bench(tmp, config="B4", traffic="orbit", n=65, size=(48, 32))
    b = json.loads(bench.read_text())
    for m in b["per_layer"]:
        if m["name"] in METRICS:
            m["workloads"].append("T.t")
    bench.write_text(json.dumps(b))
    cell = cells.resolve("T.t", bench, tmp)
    got = {}
    real = {m.name: m.read for m in cell.metrics}
    spied = [cells.Metric(m.name, m.unit, m.per_layer,
                          (lambda ctx, name=m.name: got.setdefault(name, real[name](ctx))))
             for m in cell.metrics]
    out = run.run_cell(cells.Cell(cell.name, cell.chips, cell.config, cell.traffic,
                                  tuple(spied)), 5, 0.5, True, torch.device("cpu"), sys.stderr)
    return out, got


@pytest.mark.parametrize("metric", METRICS)
def test_reader_returns_none_on_a_cpu_run(cpu_run, metric):
    out, got = cpu_run
    assert out["correct"] is True
    assert metric in got and got[metric] is None
    assert metric not in out["metrics"]


def test_span_ops_charges_each_op_to_every_span_around_its_launch(tmp_path):
    """`span_ops.read` on a made-up trace of one frame: a kernel launched
    inside `hmrt.shade.fog` counts to it and to the spans around it, one
    launched outside it only to those."""
    from port_bench import span_ops
    from port_bench.trace import FRAME, RENDER

    def ann(name, ts, dur):
        return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": 1}

    def launch(corr, ts, k_ts, dur):
        return [{"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
                 "tid": 1, "args": {"correlation": corr}},
                {"cat": "kernel", "name": f"void k{corr}()", "ts": k_ts, "dur": dur,
                 "tid": 7, "args": {"correlation": corr}}]

    events = [ann(FRAME, 0, 1000), ann(RENDER, 1, 900), ann("hmrt.frame", 2, 890),
              ann("hmrt.shade", 100, 700), ann("hmrt.shade.fog", 300, 100)]
    events += launch(1, 150, 200, 40) + launch(2, 310, 400, 30) + launch(3, 350, 450, 20)
    events += launch(4, 950, 960, 10)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = span_ops.read(str(path))
    assert got.frames == 1
    assert got.busy_s == pytest.approx({"hmrt.frame": 90e-6, "hmrt.shade": 90e-6,
                                        "hmrt.shade.fog": 50e-6})
    assert got.ms("hmrt.shade.fog") == pytest.approx(0.05)
    assert got.ms("hmrt.shadow") is None
