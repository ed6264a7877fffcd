"""A tiny benchmark folder for the CPU tests: the real metric readers, and
one configuration and traffic mix cut from the real ones to a size the
CPU renders in a fraction of a second."""

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
#: readers with no entry in BENCHMARK.json (tiny_bench)
UNLISTED = {"fog_ms", "gather_ms", "gather_roofline", "band_imbalance_pct"}


def tiny_bench(tmp: Path, config: str = "B3", traffic: str = "flyover", n: int = 65,
               size=(48, 32), chips: int = 1) -> Path:
    """Write BENCHMARK.json and configs/, traffic/, metrics/ under `tmp`
    for one cell "T.t" on `chips` ranks: `config` at an n x n map and
    `size` frames, `traffic` with a 12-frame lap. Every reader under
    metrics/ has an entry: BENCHMARK.json's, or an entry for no cell. The
    second is for the readers BENCHMARK.json does not list (UNLISTED):
    `fog_ms`, kept with `span_ops.py` while two tests under tests/ run them
    (test_torch_b4_metrics.py's span_ops case and its fog_ms case of the
    CPU-run readers), which goes with them; and the band readers of a cell
    over four cards, held back until its runs are steady enough for its
    bounds, which the multi-rank tests read. Returns the benchmark file."""
    for d in ("configs", "traffic"):
        (tmp / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(HERE / "metrics", tmp / "metrics", dirs_exist_ok=True)
    cfg = json.loads((HERE / "configs" / f"{config}.json").read_text())
    cfg.update(name="T", map_n=n)
    cfg["render"].update(width=size[0], height=size[1])
    (tmp / "configs" / "T.json").write_text(json.dumps(cfg))
    tr = json.loads((HERE / "traffic" / f"{traffic}.json").read_text())
    tr.update(frames_per_lap=12, warmup_frames=2, check_span=2, trace_frames=2, named_frames=1)
    (tmp / "traffic" / "t.json").write_text(json.dumps(tr))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"] = [{"name": "T.t", "config": "T", "traffic": "t", "chips": chips,
                           "why": "a test cell"}]
    listed = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    unlisted = sorted(f.stem for f in (HERE / "metrics").glob("*.py"))
    unlisted = [name for name in unlisted if name not in listed]
    assert set(unlisted) <= UNLISTED, f"readers BENCHMARK.json does not list: {unlisted}"
    bench["per_layer"] += [{"name": name, "unit": "ms", "better": "lower",
                            "source": "device_trace", "layer": "unlisted",
                            "moves": "frames_per_s", "workloads": []} for name in unlisted]
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


@pytest.fixture
def tiny(tmp_path):
    return tiny_bench(tmp_path)
