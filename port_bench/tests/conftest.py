"""A tiny benchmark folder for the CPU tests: the real metric readers, and
one configuration and traffic mix cut from the real ones to a size the
CPU renders in a fraction of a second."""

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def tiny_bench(tmp: Path, config: str = "B3", traffic: str = "flyover", n: int = 65,
               size=(48, 32)) -> Path:
    """Write BENCHMARK.json and configs/, traffic/, metrics/ under `tmp`
    for one cell "T.t": `config` at an n x n map and `size` frames,
    `traffic` with a 12-frame lap. Returns the benchmark file."""
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
    bench["workloads"] = [{"name": "T.t", "config": "T", "traffic": "t", "chips": 1,
                           "why": "a test cell"}]
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


@pytest.fixture
def tiny(tmp_path):
    return tiny_bench(tmp_path)
