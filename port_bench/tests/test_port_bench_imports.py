"""What a run loads: never jax, jaxlib, flax or the JAX package hmrt_tpu
(top-level names compared whole: hmrt_tpu_torch is not hmrt_tpu); and the
reference loads nothing of the port either. Each in a fresh interpreter,
so that nothing the test runner imported counts."""

import json
import subprocess
import sys

import pytest

from port_bench.tests.conftest import ROOT

RUN = """
import json, sys, tempfile, torch
from pathlib import Path
from port_bench import cells, run
from port_bench.tests.conftest import tiny_bench
tmp = Path(tempfile.mkdtemp())
cell = cells.resolve("T.t", tiny_bench(tmp), tmp)
out = run.run_cell(cell, 1, 1.0, True, torch.device("cpu"), sys.stderr)
assert out["correct"]
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys, torch
from port_bench.reference.render import render
h = torch.rand(33, 33) * 4
light = dict(sun_dir=[0.4, 0.3, 0.85], sun_color=[1, 1, 1], sky_top=[0, 0, 1],
             sky_horizon=[1, 1, 1], fog_color=[0.5, 0.5, 0.5])
cfg = dict(width=16, height=8, shading="phong", shadows=True, fog=True, texture=False,
           ambient=0.1, specular=0.5, shininess=8.0, fog_density=0.01)
render(h, None, (16.0, -10.0, 12.0), (16.0, 16.0, 2.0), 55.0, cfg, light)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = _top_level(RUN)
    assert "hmrt_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "hmrt_tpu"}


def test_the_reference_loads_nothing_of_the_port():
    mods = _top_level(REFERENCE)
    assert not mods & {"jax", "jaxlib", "flax", "hmrt_tpu", "hmrt_tpu_torch"}


def test_banned_names_are_compared_whole(monkeypatch):
    from port_bench import run
    monkeypatch.setitem(sys.modules, "hmrt_tpu_torch_extra", sys)
    assert "hmrt_tpu" not in run.banned_modules()
    monkeypatch.setitem(sys.modules, "hmrt_tpu.sub", sys)
    assert run.banned_modules() == ["hmrt_tpu"]


@pytest.mark.parametrize("workload", ["B3.flyover"])
def test_no_card_no_result(workload):
    """Without a CUDA card (or with fewer than the cell asks for) a run
    exits 3 and prints no result."""
    import torch

    from port_bench import cells
    chips = cells.resolve(workload, ROOT / "BENCHMARK.json").chips
    if torch.cuda.is_available() and torch.cuda.device_count() >= chips:
        pytest.skip(f"this machine has the {chips} card(s) that {workload} asks for")
    out = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", workload,
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 3 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    first = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", first,
                          "--seed", "5", "--seconds", "2", "--trace", "1"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
