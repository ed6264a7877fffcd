"""The benchmark of hmrt_tpu_torch, the PyTorch and CUDA port.

One run renders one cell (a configuration under a traffic mix) frame by
frame on the card, or over several cards, a process each, where the cell's
`chips` asks for them (`sharded.py`): `python -m port_bench.run --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`. A cell `<config>.<traffic>` is found by name
in `configs/<config>.json` and `traffic/<traffic>.json`, and each metric of
BENCHMARK.json by name in `metrics/<metric>.py`; adding a configuration, a
traffic mix or a metric adds files and entries, never an edit here.

Nothing here imports jax or the JAX package; `reference/` imports nothing
of the port either.
"""
