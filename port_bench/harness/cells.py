"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the checkout's root names each cell (``workloads``)
with its configuration and traffic mix. Each piece is a file of its own
under ``port_bench/``, found by that name, so a new cell, configuration,
traffic mix or per-layer metric is a new file and a new entry, and no file
that exists is edited:

- ``configs/<config>.json``: the task's configuration as it is run;
- ``traffic/<traffic>.json``: the load (samples a level, the closed loop's
  shape, the traced stretch, the steps checked);
- ``limits/<workload>.json``: the limit of each number the correctness
  check compares in that cell, with the readings it was set from;
- ``metrics/<metric>.py``: the reader of one per-layer metric.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's contents
    traffic: dict
    limits: dict  # number compared -> its limit entry ({"limit": ..., ...})
    end_to_end: tuple  # the BENCHMARK.json entries this cell reports with --trace 0
    per_layer: tuple  # ... and with --trace 1


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return read_json(path)


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(name: str, bench: dict = None, bench_dir: str = BENCH_DIR) -> Cell:
    """The cell ``name`` of the benchmark, with its files read."""
    bench = load_benchmark() if bench is None else bench
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r}; known: {sorted(by_name)}")
    w = by_name[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise KeyError(f"workload {name!r} names configuration {w['config']!r}, which BENCHMARK.json lacks")
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=read_json(os.path.join(bench_dir, "configs", f"{w['config']}.json")),
        traffic=read_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json")),
        limits=read_json(os.path.join(bench_dir, "limits", f"{name}.json"))["limits"],
        end_to_end=tuple(m for m in bench["end_to_end"] if _reports(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _reports(m, name)),
    )


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
