"""BENCHMARK.json and the files it names: a cell's configuration, its
traffic mix (portbench/traffic/<traffic>.json) and the readers of its
per-layer metrics (portbench/layer_metrics/<metric>.py), each found by the
name that BENCHMARK.json gives it."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List, NamedTuple, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    chips: int
    #: the cell's end-to-end and per-layer metric entries of BENCHMARK.json
    end_to_end: List[dict]
    per_layer: List[dict]


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def traffic_path(name: str, bench_dir: str = BENCH_DIR) -> str:
    return os.path.join(bench_dir, "traffic", f"{name}.json")


def reader_path(metric: str, bench_dir: str = BENCH_DIR) -> str:
    return os.path.join(bench_dir, "layer_metrics", f"{metric}.py")


def cell(manifest: dict, name: str, root: str = ROOT, bench_dir: str = BENCH_DIR) -> Cell:
    """The cell `name` of the manifest; KeyError if there is none."""
    w = {x["name"]: x for x in manifest["workloads"]}[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(traffic_path(w["traffic"], bench_dir)) as f:
        traffic = json.load(f)
    return Cell(name, config, traffic, int(w["chips"]),
                [m for m in manifest["end_to_end"] if _applies(m, name)],
                [m for m in manifest["per_layer"] if _applies(m, name)])


def reader(metric: str, bench_dir: str = BENCH_DIR) -> Callable[[dict], Optional[float]]:
    """The `read(context)` function of a per-layer metric's reader."""
    path = reader_path(metric, bench_dir)
    spec = importlib.util.spec_from_file_location(f"portbench_layer_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def readers(metrics: List[dict], bench_dir: str = BENCH_DIR) -> Dict[str, Callable]:
    return {m["name"]: reader(m["name"], bench_dir) for m in metrics}
