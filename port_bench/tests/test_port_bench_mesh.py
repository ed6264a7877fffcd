"""A run over several ranks (sharded.py), on the CPU: two gloo ranks drive
the band-sharded path end to end at a tiny size; the timed path broken
underneath makes the run not correct, for each fault such a cell can
have; a rank that raises or hangs ends the run; the readers of the band
metrics on made-up traces; and the split of the host's cores among the
ranks."""

import dataclasses
import json
import sys
import time

import pytest
import torch

from port_bench import cells, hostinfo, sharded, stages
from port_bench.roofline import HBM_BYTES_PER_S, NVLINK_BYTES_PER_S, frame_bytes, gather_bytes
from port_bench.tests.conftest import HERE, tiny_bench
from port_bench.trace import Trace

BAND = ("gather_ms", "gather_roofline", "band_imbalance_pct")
#: the stage metrics, read on a card from the armed sub-run of every rank
STAGES = ("raygen_ms", "march_ms", "sort_ms", "shadow_ms", "shade_ms", "live_lane_pct")
#: the ranks' parent started this long before the run, so set-up reads at least that
PARENT_AGE_S = 100.0


def band_cell(tmp, chips: int = 2, n: int = 128, size=(128, 64)):
    """B5 cut to an n x n map and `size` frames, on `chips` ranks, with
    the band and stage metrics listed for it."""
    bench = tiny_bench(tmp, "B5", "flyover", n=n, size=size, chips=chips)
    b = json.loads(bench.read_text())
    for m in b["per_layer"]:
        if m["name"] in BAND + STAGES:
            m["workloads"].append("T.t")
    bench.write_text(json.dumps(b))
    return cells.resolve("T.t", bench, tmp)


def run_band(cell, seconds=2.0, traced=False, render=None, join_timeout=120.0,
             device="cpu"):
    return sharded.run_mesh(cell, 2**31 + 7, seconds, traced, sys.stderr,
                            time.time() - PARENT_AGE_S, devices=[device] * cell.chips,
                            backend="gloo", render=render, join_timeout=join_timeout)


def _sharded(scene, cam, rc, mesh):
    from hmrt_tpu_torch.distrib.mesh import render_frame_sharded
    return render_frame_sharded(scene, cam, rc, mesh)


# the faults: picklable, since each rank unpickles its own copy

class Stale:
    """A step that returns its state unchanged: the first frame, every time
    (each frame still rendered and gathered, so the ranks keep step)."""
    def __init__(self):
        self.first = None

    def __call__(self, scene, cam, rc, mesh):
        fr = _sharded(scene, cam, rc, mesh)
        if self.first is None:
            self.first = fr
        return self.first


class Half:
    """Half of the batch left out: the lower half of the rows never rendered."""
    def __call__(self, scene, cam, rc, mesh):
        fr = _sharded(scene, cam, rc, mesh)
        h = rc.height // 2
        color, hit = fr.color.clone(), fr.hit.clone()
        color[h:], hit[h:] = 0.0, False
        return dataclasses.replace(fr, color=color, hit=hit)


class NoExchange:
    """The exchange between the cards left out: each rank's band in its
    place of a frame that is otherwise blank, with no gather."""
    def __call__(self, scene, cam, rc, mesh):
        from hmrt_tpu_torch.distrib.mesh import render_band
        band = rc.height // mesh.size
        fr = render_band(scene, cam, dataclasses.replace(rc, height=band), mesh.rank * band,
                         rc.height)
        color = fr.color.new_zeros((rc.height, rc.width, 3))
        hit = fr.hit.new_zeros((rc.height, rc.width))
        rows = slice(mesh.rank * band, (mesh.rank + 1) * band)
        color[rows], hit[rows] = fr.color, fr.hit
        return dataclasses.replace(fr, color=color, hit=hit)


def _shifted(fr):
    return dataclasses.replace(fr, color=torch.clamp(fr.color + 0.02, 0.0, 0.99))


class Altered:
    """An answer altered where it is produced: the frame's colour shifted."""
    def __call__(self, scene, cam, rc, mesh):
        return _shifted(_sharded(scene, cam, rc, mesh))


class OtherRanksAltered:
    """Every rank but 0 holds a frame other than rank 0's."""
    def __call__(self, scene, cam, rc, mesh):
        fr = _sharded(scene, cam, rc, mesh)
        return fr if mesh.rank == 0 else _shifted(fr)


class RaiseOnRank1:
    def __call__(self, scene, cam, rc, mesh):
        if mesh.rank == 1:
            raise RuntimeError("rank 1 fails on purpose")
        return _sharded(scene, cam, rc, mesh)


class HangOnRank1:
    def __call__(self, scene, cam, rc, mesh):
        if mesh.rank == 1:
            time.sleep(3600)
        return _sharded(scene, cam, rc, mesh)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cell = band_cell(tmp_path_factory.mktemp("band"))
    return cell, run_band(cell), run_band(cell, traced=True)


def test_two_ranks_run_correct(runs):
    _, (out, banned), (traced, _) = runs
    for o in (out, traced):
        assert o["correct"] is True and o["failed"] == 0, o["checks"]
        assert o["device"]["count"] == 2 and o["attempted"] > 2
        assert list(o)[-1] == "checks"
    assert banned == []
    # the same frames on every rank: an exact comparison
    assert out["checks"]["rank_frames"] == {"value": 0, "limit": 0}
    assert {"hit_px", "color_px"} <= set(out["checks"])


def test_setup_is_taken_from_the_parent_start(runs):
    _, (out, _), _ = runs
    m = out["metrics"]
    assert m["setup_s"]["value"] >= PARENT_AGE_S
    assert m["frames_per_s"]["value"] > 0 and m["frame_p95_ms"]["value"] > 0


def test_band_metrics_are_left_out_without_a_card(runs):
    """The CPU's trace has no device op: the band metrics and the stages
    read nothing."""
    _, (out, _), (traced, _) = runs
    assert not set(BAND) & set(out["metrics"])
    assert not (set(BAND) | set(STAGES)) & set(traced["metrics"])
    assert "scene_build_s" in traced["metrics"]
    assert traced["breakdown"]["device_ops"] == []
    assert all(name.startswith("rank0 ") for name, _ in traced["breakdown"]["idle_gaps"])


@pytest.mark.parametrize("fault", [Stale, Half, NoExchange, Altered, OtherRanksAltered])
def test_fault_makes_the_run_incorrect(tmp_path, fault):
    out, _ = run_band(band_cell(tmp_path), seconds=1.0, render=fault())
    assert out["correct"] is False and out["failed"] > 0, out["checks"]


@pytest.mark.parametrize("fault, error", [(RaiseOnRank1, torch.multiprocessing.ProcessRaisedException),
                                          (HangOnRank1, TimeoutError)])
def test_a_failing_rank_ends_the_run(tmp_path, fault, error):
    t = time.monotonic()
    with pytest.raises(error):
        run_band(band_cell(tmp_path), seconds=1.0, render=fault(), join_timeout=30.0)
    assert time.monotonic() - t < 60.0


def test_the_pacing_rank_is_the_slowest_band():
    assert sharded.pacing_rank([1.0, 3.0, 2.0, 3.0]) == 1
    assert sharded.pacing_rank([0.0, 0.0]) == 0


def _trace(ops, frames=2, busy_s=None):
    busy = sum(s for _, s in ops) if busy_s is None else busy_s
    return Trace(frames=frames, window_s=2 * busy + 1e-3, busy_s=busy, ops=ops, kernels=len(ops),
                 waits=0, gaps=[])


def _reader(name):
    return cells.load_reader(HERE / "metrics" / f"{name}.py")


def _ctx(trace, facts, render=None):
    from port_bench.run import Ctx
    render = render or {"width": 3840, "height": 2160, "texture": False}
    return Ctx(frame_s=[0.01], window_s=0.01, facts=facts, trace=trace,
               config={"render": render}, traffic={})


GATHER_OP = "ncclDevKernel_AllGather_RING_LL"


def test_band_imbalance_on_made_up_traces():
    ranks = [_trace([("march_pass_kernel<false, 0>", b), (GATHER_OP, 4e-3 - b)])
             for b in (3e-3, 2e-3, 2e-3, 1e-3)]
    busy = [sharded.band_busy_s(t) for t in ranks]
    assert busy == pytest.approx([3e-3, 2e-3, 2e-3, 1e-3])
    assert sharded.pacing_rank(busy) == 0
    got = _reader("band_imbalance_pct")(_ctx(ranks[0], {"band_busy_s": busy}))
    assert got == pytest.approx(100 * (1 - 2e-3 / 3e-3))
    assert _reader("band_imbalance_pct")(_ctx(ranks[0], {"band_busy_s": [0.0, 0.0]})) is None


def test_each_gather_is_read_on_the_rank_that_entered_it_last():
    """Rank 0 enters the first gather late (its kernel there is the
    transfer alone), rank 1 the second."""
    ranks = [_trace([("march_pass_kernel<false, 0>", 4e-3), (GATHER_OP, 0.3e-3),
                     (GATHER_OP, 2.0e-3)]),
             _trace([(GATHER_OP, 1.5e-3), ("march_pass_kernel<false, 0>", 4e-3),
                     (GATHER_OP, 0.1e-3)])]
    assert sharded.gather_seconds(ranks) == pytest.approx(0.4e-3)
    assert sharded.gather_seconds([_trace([("k", 1e-3)])] * 2) == 0


def test_gather_bytes_and_roofline():
    render = {"width": 3840, "height": 2160}
    assert gather_bytes(render, 4) == 3840 * 2160 * 13 * 3 // 4 == 80_870_400
    assert gather_bytes(render, 1) == 0
    t = _trace([("march_pass_kernel<false, 0>", 4e-3)], frames=2)
    ctx = _ctx(t, {"chips": 4, "gather_s": 0.6e-3})
    assert _reader("gather_ms")(ctx) == pytest.approx(0.3)
    assert _reader("gather_roofline")(ctx) == pytest.approx(
        80_870_400 / NVLINK_BYTES_PER_S / 0.3e-3 * 100)
    assert _reader("gather_roofline")(_ctx(t, {"chips": 1, "gather_s": 0.6e-3})) is None
    for facts in ({"chips": 4, "gather_s": 0}, {"chips": 4}):
        assert _reader("gather_ms")(_ctx(t, facts)) is None
        assert _reader("gather_roofline")(_ctx(t, facts)) is None


def test_torch_ops_leave_out_the_gathers():
    t = _trace([("march_pass_kernel<false, 0>", 4e-3), ("ray_sort_gather", 1e-3),
                (GATHER_OP, 3e-3)], frames=1)
    assert _reader("torch_ops_ms")(_ctx(t, {})) == pytest.approx(1.0)


def test_frame_roofline_on_one_card_is_the_old_formula():
    render = {"width": 1920, "height": 1080, "texture": False}
    t = _trace([("march_pass_kernel<false, 0>", 2.5e-3)] * 2)
    hits = [1_100_000, 1_050_000]
    old = sum(frame_bytes(render, h) for h in hits) / HBM_BYTES_PER_S / t.busy_s * 100.0
    read = _reader("frame_roofline")
    assert read(_ctx(t, {"traced_hit_pixels": hits}, render)) == old
    assert read(_ctx(t, {"traced_hit_pixels": hits, "chips": 1}, render)) == old
    assert read(_ctx(t, {"traced_hit_pixels": hits, "chips": 4}, render)) == pytest.approx(old / 4)


def test_frame_roofline_and_idle_on_a_mesh_count_the_gathers_spin_as_idle():
    """The pacing rank's busy time is its band's ops and the gathers'
    transfer: the 2.5 ms its gather kernel spins waiting for rank 1 is
    idle, as the device's gaps are."""
    ranks = [_trace([("march_pass_kernel<false, 0>", 3e-3), (GATHER_OP, 2.8e-3)], frames=1,
                    busy_s=5.8e-3),
             _trace([("march_pass_kernel<false, 0>", 0.5e-3), (GATHER_OP, 0.3e-3)], frames=1,
                    busy_s=0.8e-3)]
    ranks[0].window_s = ranks[1].window_s = 8e-3
    facts = sharded.trace_facts(ranks)
    assert facts["pacing_rank"] == 0 and facts["band_busy_s"] == pytest.approx([3e-3, 0.5e-3])
    assert facts["gather_s"] == pytest.approx(0.3e-3)
    assert facts["device_busy_s"] == pytest.approx(3.3e-3)
    render = {"width": 3840, "height": 2160, "texture": False}
    hits = [4_000_000]
    ctx = _ctx(ranks[0], {**facts, "chips": 2, "traced_hit_pixels": hits}, render)
    assert _reader("device_idle_pct")(ctx) == pytest.approx((1 - 3.3 / 8) * 100)
    assert _reader("frame_roofline")(ctx) == pytest.approx(
        frame_bytes(render, hits[0]) / (2 * HBM_BYTES_PER_S) / 3.3e-3 * 100)
    # on one card, with no such fact, both read the trace's busy time
    one = _ctx(ranks[0], {"traced_hit_pixels": hits}, render)
    assert _reader("device_idle_pct")(one) == pytest.approx((1 - 5.8 / 8) * 100)
    assert _reader("frame_roofline")(one) == pytest.approx(
        frame_bytes(render, hits[0]) / HBM_BYTES_PER_S / 5.8e-3 * 100)


def test_the_band_span_holds_a_ranks_frame_in_the_stage_reading(tmp_path):
    """On a rank of a mesh the port opens `hmrt.band` and no `hmrt.frame`:
    the gap before the raygen launch is charged to raygen from the band's
    start, as from a frame's; the gather after the band is a stage of its
    own."""
    from port_bench.trace import FRAME, RENDER

    def span(name, ts, end):
        return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": end - ts,
                "pid": 1, "tid": 1}

    def launch(ts, corr):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                "dur": 5, "pid": 1, "tid": 1, "args": {"correlation": corr}}

    def kernel(name, ts, end, corr):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": end - ts, "pid": 0,
                "tid": 7, "args": {"correlation": corr}}

    events = [span(FRAME, 0, 1000), span(RENDER, 0, 950), span("hmrt.band", 10, 600),
              span("hmrt.raygen", 20, 200), span("hmrt.gather", 600, 900),
              launch(50, 1), launch(650, 2),
              kernel("void k1(int)", 100, 300, 1), kernel(GATHER_OP + "(int)", 700, 900, 2)]
    path = tmp_path / "band.json"
    path.write_text(json.dumps({"traceEvents": events}))
    r = stages.read(str(path))
    assert (r.stages["raygen"].busy_s, r.stages["raygen"].idle_s) == pytest.approx((200e-6, 40e-6))
    assert r.stages["gather"].busy_s == pytest.approx(200e-6)
    assert r.ms("raygen") == pytest.approx(0.24)


@pytest.mark.parametrize("near, want", [
    # two NUMA nodes, two cards on each: each card's ranks share its node's cores
    ([{0, 1, 2, 3, 8, 9, 10, 11}] * 2 + [{4, 5, 6, 7, 12, 13, 14, 15}] * 2,
     [[0, 8, 1, 9], [2, 10, 3, 11], [4, 12, 5, 13], [6, 14, 7, 15]]),
    # nothing known of the cards: all cores in rank order
    ([None] * 4, [[0, 8, 1, 9], [2, 10, 3, 11], [4, 12, 5, 13], [6, 14, 7, 15]]),
    # one card's node has fewer cores than its ranks: all cores in rank order
    ([{0, 8}, {0, 8}, None, None], [[0, 8, 1, 9], [2, 10, 3, 11], [4, 12, 5, 13],
                                    [6, 14, 7, 15]]),
    # every core near every card, two ranks: half each
    ([set(range(16))] * 2, [[0, 8, 1, 9, 2, 10, 3, 11], [4, 12, 5, 13, 6, 14, 7, 15]]),
])
def test_the_ranks_get_whole_cores_of_their_own(near, want):
    cores = [(c, c + 8) for c in range(8)]
    got = hostinfo.split_cores(cores, near)
    assert got == want
    flat = [c for cpus in got for c in cpus]
    assert len(flat) == len(set(flat))


def test_too_few_cores_bind_no_rank():
    assert hostinfo.split_cores([(0,), (1,)], [None] * 4) is None
    assert hostinfo.cpu_list("0-3,8,10-11\n") == {0, 1, 2, 3, 8, 10, 11}
    assert hostinfo.card_local_cpus(object()) is None
