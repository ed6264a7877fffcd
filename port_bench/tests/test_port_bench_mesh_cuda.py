"""The multi-rank path of a run on the card: two gloo ranks share it (as
`distrib/mesh.py` allows; NCCL takes one card a rank), on a map that takes
the compact path, and every frame of the window equals `render_frame`'s
of the same view bit for bit; a traced run reads the band metrics and the
stages of the pacing rank's band."""

import pytest
import torch

from port_bench import sharded  # noqa: F401  (the ranks import it by name)
from port_bench.tests.test_port_bench_mesh import STAGES, band_cell, run_band


class SideBySide:
    """The port's sharded frame, held on rank 0 against `render_frame` of
    the same view: any bit that differs fails the run."""
    def __call__(self, scene, cam, rc, mesh):
        from hmrt_tpu_torch.core.renderer import render_frame
        from hmrt_tpu_torch.distrib.mesh import render_frame_sharded
        fr = render_frame_sharded(scene, cam, rc, mesh)
        if mesh.rank == 0:
            want = render_frame(scene, cam, rc)
            if not (torch.equal(fr.color, want.color) and torch.equal(fr.hit, want.hit)):
                raise AssertionError(
                    f"sharded frame differs from render_frame: "
                    f"{int((fr.hit != want.hit).sum())} hit pixels, colour by "
                    f"{float((fr.color - want.color).abs().max())}")
        return fr


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_two_ranks_on_one_card_equal_render_frame(tmp_path, card):
    cell = band_cell(tmp_path, n=1024, size=(256, 128))
    out, banned = run_band(cell, seconds=2.0, render=SideBySide(), device=card)
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert out["device"]["platform"] == "gpu" and banned == []
    assert out["checks"]["rank_frames"]["value"] == 0


@pytest.mark.cuda
def test_a_traced_run_on_the_card_reads_the_bands(tmp_path, card):
    cell = band_cell(tmp_path, n=1024, size=(256, 128))
    out, _ = run_band(cell, seconds=2.0, traced=True, device=card)
    m = out["metrics"]
    assert out["correct"] is True, out["checks"]
    assert 0 <= m["band_imbalance_pct"]["value"] < 100
    assert 0 < m["frame_roofline"]["value"] <= 100
    assert 0 <= m["device_idle_pct"]["value"] < 100
    assert out["device"]["busy_s"] > 0
    # gloo gathers through host copies: no NCCL kernel to read
    assert "gather_ms" not in m and "gather_roofline" not in m
    # the stages of the pacing rank's band, from its armed sub-run
    for name in STAGES[:-1]:
        assert m[name]["value"] > 0, name
    assert 0 < m["live_lane_pct"]["value"] <= 100
