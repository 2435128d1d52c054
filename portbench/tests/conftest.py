"""Shared fixtures of the benchmark's tests: cells cut to a size that a
test holds (the same configuration and traffic files, smaller numbers), and
the card, decided inside a fixture."""

import copy
import json
import os
import sys
import time

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench.pbcore import harness, manifest  # noqa: E402

#: a library of 16 genomes of 10-60 kbp and samples of 300 pairs, with more N than the cells'
TINY = {"library": {"size_median_bp": 20_000, "size_min_bp": 10_000, "size_max_bp": 60_000}, "n_species": 16,
        "pairs": 300, "outside_bp": 20_000, "reads": {"n_rate": 0.002, "n_run_share": 0.05}}

#: cells whose traffic kinds are here but which BENCHMARK.json does not list yet:
#: (config, traffic, end-to-end metrics, per-layer metrics)
EXTRA = {"marine.build": ("marine", "build", ["build_mbp_per_s", "build_peak_gib"],
                          ["build_packing_pct", "device_idle_pct.build"]),
         "strain.bracken": ("strain", "bracken", ["bracken_mwindows_per_s"], ["device_idle_pct.bracken"])}
UNITS = {"build_mbp_per_s": "Mbp/s", "build_peak_gib": "GiB", "bracken_mwindows_per_s": "Mwindows/s", "setup_s": "s"}


def _cell(name: str) -> manifest.Cell:
    m = manifest.load()
    if name not in EXTRA:
        return manifest.cell(m, name)
    config, traffic, e2e, layer = EXTRA[name]
    with open(os.path.join(manifest.ROOT, {c["name"]: c for c in m["configs"]}[config]["file"])) as f:
        cfg = json.load(f)
    with open(manifest.traffic_path(traffic)) as f:
        tr = json.load(f)
    return manifest.Cell(name, cfg, tr, 1, [{"name": n, "unit": UNITS[n]} for n in e2e + ["setup_s"]],
                         [{"name": n, "unit": "%"} for n in layer])


def tiny_cell(name: str) -> manifest.Cell:
    c = _cell(name)
    cfg, tr = copy.deepcopy(c.config), copy.deepcopy(c.traffic)
    cfg["library"].update(TINY["library"])
    cfg["taxonomy"]["n_species"] = TINY["n_species"]
    cfg["reads"]["outside_bp"] = TINY["outside_bp"]
    cfg["reads"].update(TINY["reads"])
    if "pairs_per_sample" in tr:
        tr["pairs_per_sample"] = TINY["pairs"]
        tr["lines_compared_per_sample"] = min(int(tr["lines_compared_per_sample"]), 100)
    return c._replace(config=cfg, traffic=tr)


def run_tiny(name: str, seed: int = 20261018, seconds: float = 1.0, device="cpu", control: int = 0,
             trace: bool = False) -> dict:
    return harness.run(tiny_cell(name), seed, seconds, trace, device, time.perf_counter(), control=control)


CELLS = [w["name"] for w in manifest.load()["workloads"]]
#: the cells and the extra cells, all that the tests run
ALL_CELLS = CELLS + list(EXTRA)


def pytest_configure(config):
    import torch

    torch.set_num_threads(2)  # several test workers share the cores


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
