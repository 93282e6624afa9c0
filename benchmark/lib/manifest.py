"""Finds a cell's parts by name: its entry in BENCHMARK.json, its
configuration file, its traffic mix (a data file under
benchmark/traffic/), the traffic kind's generator (benchmark/kinds/) and
the readers of its per-layer metrics (benchmark/metrics/).  Adding a
cell, a configuration, a mix or a metric adds files and entries and
edits nothing here."""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    """Whether a metric is reported in ``cell``: every cell, unless the
    metric lists its cells under ``workloads``."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell(manifest: dict, name: str, root: str = ROOT) -> dict:
    """Everything one run of cell ``name`` needs, resolved from files."""
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    config = _read_json(os.path.join(root, conf["file"]))
    traffic = _read_json(os.path.join(root, "benchmark", "traffic",
                                      w["traffic"] + ".json"))
    bench = os.path.join(root, "benchmark")
    return {
        "workload": w,
        "config": config,
        "traffic": traffic,
        "kind": os.path.join(bench, "kinds", traffic["kind"] + ".py"),
        "end_to_end": [m for m in manifest["end_to_end"]
                       if reports(m, name)],
        "per_layer": [dict(m, reader=os.path.join(bench, "metrics",
                                                   m["name"] + ".py"))
                      for m in manifest["per_layer"] if reports(m, name)],
    }


def load_module(path: str):
    """Import a file by path (metric files carry dots in their names)."""
    mod_name = "benchmark_file_" + os.path.relpath(path, BENCH_DIR).replace(
        os.sep, "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
