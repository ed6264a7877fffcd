"""Find a cell's files by name: the benchmark is driven by data.

A cell `<config>.<traffic>` of BENCHMARK.json's `workloads` names a
configuration file, a traffic file and, through the metrics that list it
(or list no cells), one reader per metric, each found under the
benchmark's folder by name alone:

    configs/<config>.json    the configuration as it is run
    traffic/<traffic>.json   the traffic mix (paths.py reads it)
    metrics/<metric>.py      `read(ctx) -> float | None`, one metric each
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    per_layer: bool
    read: object  # callable(ctx) -> float | None


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: tuple  # Metric, end-to-end ones first


def load_reader(path: Path):
    """The `read` function of a metric's file."""
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def resolve(name: str, bench_file: Path, folder: Path = HERE) -> Cell:
    """The cell `name` of the benchmark file, with its files under `folder`."""
    bench = json.loads(Path(bench_file).read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_file} (has {sorted(cells)})")
    w = cells[name]
    config = json.loads((folder / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((folder / "traffic" / f"{w['traffic']}.json").read_text())
    metrics = tuple(
        Metric(m["name"], m["unit"], per_layer,
               load_reader(folder / "metrics" / f"{m['name']}.py"))
        for per_layer, key in ((False, "end_to_end"), (True, "per_layer"))
        for m in bench[key] if _applies(m, name))
    return Cell(name, int(w["chips"]), config, traffic, metrics)
