"""Find the benchmark's parts by name: cells in BENCHMARK.json,
configurations in configs/<name>.json, traffic mixes in
traffic/<name>.json and per-layer metrics in metrics/<name>.py.  A new
part is a new file and a new entry; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ".") -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, base: str = HERE) -> dict:
    return load_json(os.path.join(base, "configs", f"{name}.json"))


def traffic(name: str, base: str = HERE) -> dict:
    return load_json(os.path.join(base, "traffic", f"{name}.json"))


def metric(name: str, base: str = HERE):
    """The module of metrics/<name>.py (names hold dots, so it is loaded
    from its path)."""
    path = os.path.join(base, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "asmbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, workload: str, kind: str) -> list[dict]:
    """The entries of `kind` ("end_to_end" or "per_layer") that the cell
    reports: those without a workloads list, and those that list it."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]
