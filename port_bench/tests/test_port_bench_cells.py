"""Every cell resolves by name to its files, a new configuration, traffic
mix and metric are found with no edit to the harness, and BENCHMARK.json
keeps to the benchmark's contract."""

import json
import re
import sys

import pytest
import torch

from port_bench import cells, run
from port_bench.tests.conftest import HERE, ROOT, tiny_bench

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    c = cells.resolve(cell, ROOT / "BENCHMARK.json")
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c.config["name"] == w["config"] and c.chips == w["chips"]
    assert {"frames_per_lap", "fov_deg", "loop", "look"} <= set(c.traffic)
    names = [m.name for m in c.metrics]
    assert "setup_s" in names and any(not m.per_layer and m.name != "setup_s" for m in c.metrics)
    assert any(m.per_layer for m in c.metrics)
    assert all(callable(m.read) for m in c.metrics)


def test_contract_of_the_benchmark_file():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for cfg in BENCH["configs"]:
        assert cfg["file"] == f"port_bench/configs/{cfg['name']}.json"
        # each cut is a name: a key of the configuration's file changed from
        # its source, or a cut of scale that the file's deployment names
        keys = json.loads((ROOT / cfg["file"]).read_text())
        assert len(cfg["reduced"]) <= 16
        for cut in cfg["reduced"]:
            assert isinstance(cut, str) and NAME.match(cut), (cfg["name"], cut)
            assert cut in keys or re.search(rf"\b{re.escape(cut)}\b", keys.get("deployment", "")), \
                (cfg["name"], cut)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
    for entry in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
        assert len(entry.get("why", "x")) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) and m["better"] in ("lower", "higher")
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_new_files_are_found_without_an_edit(tmp_path):
    bench = tiny_bench(tmp_path)
    (tmp_path / "metrics" / "twice_build_s.py").write_text(
        "def read(ctx):\n    return 2 * ctx.facts['scene_build_s']\n")
    b = json.loads(bench.read_text())
    b["per_layer"].append({"name": "twice_build_s", "unit": "s", "better": "lower",
                           "source": "host_clock", "layer": "scene build", "moves": "setup_s"})
    bench.write_text(json.dumps(b))
    cell = cells.resolve("T.t", bench, tmp_path)
    assert cell.config["name"] == "T" and cell.traffic["frames_per_lap"] == 12
    out = run.run_cell(cell, 2**31 + 9, 1.0, True, torch.device("cpu"), sys.stderr)
    m = out["metrics"]
    assert m["twice_build_s"]["value"] == pytest.approx(2 * m["scene_build_s"]["value"])
    assert out["correct"] is True
    assert list(out)[-1] == "checks"


def test_the_band_cell_takes_four_cards(tmp_path):
    """B5 over four ranks (held back from BENCHMARK.json until its runs
    are steady): its rows split evenly, and the band and stage metrics
    resolve for it and for no one-card cell."""
    bench = tiny_bench(tmp_path, "B5", "flyover", chips=4)
    b = json.loads(bench.read_text())
    band = {"gather_ms", "gather_roofline", "band_imbalance_pct"}
    for m in b["per_layer"]:
        if m["name"] in band:
            m["workloads"].append("T.t")
    bench.write_text(json.dumps(b))
    c = cells.resolve("T.t", bench, tmp_path)
    cfg = json.loads((HERE / "configs" / "B5.json").read_text())
    assert c.chips == 4 and cfg["render"]["height"] % c.chips == 0
    assert re.search(r"\bchips\b", cfg["deployment"])
    names = {m.name for m in c.metrics}
    assert band | {"frame_p95_ms", "setup_s"} <= names
    assert not band & {m.name for m in cells.resolve("B3.flyover", ROOT / "BENCHMARK.json").metrics}


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        cells.resolve("B3.nothing", ROOT / "BENCHMARK.json")
