"""BENCHMARK.json and the files it names, found by name: a cell's
configuration (`configs/<name>.json`, its sizes, and `configs/<name>.py`,
its generator), its traffic mix (`traffic/<name>.json`) and each metric's
reader (`metrics/<name>.py`)."""

from __future__ import annotations

import hashlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent


def load_module(path: Path):
    """The Python file at `path` as a module of its own."""
    path = Path(path).resolve()
    name = "portbench_file_" + hashlib.sha1(str(path).encode()).hexdigest()[:16]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_benchmark(bench_dir: Path = BENCH_DIR) -> dict:
    """BENCHMARK.json at the root of the checkout that holds `bench_dir`."""
    with open(Path(bench_dir).parent / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, bench_dir: Path = BENCH_DIR):
    """(sizes dict, generator module) of configuration `name`."""
    with open(Path(bench_dir) / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    return cfg, load_module(Path(bench_dir) / "configs" / f"{name}.py")


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    with open(Path(bench_dir) / "traffic" / f"{name}.json") as f:
        return json.load(f)


def metric(name: str, bench_dir: Path = BENCH_DIR):
    """The reader module of metric `name` (`read(ctx)`): `metrics/<name>.py`,
    or for a quantity split by the end-to-end metric it moves
    (`device_idle_pct.reencoded`) the reader of the part before the first
    dot."""
    path = Path(bench_dir) / "metrics" / f"{name}.py"
    if not path.is_file():
        path = Path(bench_dir) / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(path)


def cell_metrics(bench: dict, cell: str, traced: bool) -> list:
    """The metric entries a run of `cell` reports: the end-to-end ones
    untraced, the per-layer ones traced; an entry with a "workloads" list
    only in those cells."""
    entries = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]
