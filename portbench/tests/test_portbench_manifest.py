"""BENCHMARK.json against the benchmark's contract, and the files that the
harness finds by the names it gives."""

import json
import os
import re
import shutil
import subprocess
import sys


from portbench.pbcore import manifest

M = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|expansion|_dim$|_rank$|experts_per_token)")


def all_metrics():
    return M["end_to_end"] + M["per_layer"]


def test_top_level_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(M["paths"]) <= 16 and all(re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) for p in M["paths"])
    assert 1 <= len(M["command"]) <= 32 and all(TEXT.match(w) for w in M["command"])
    assert not any(w.startswith("/") or ".." in w for w in M["command"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert 1 <= len(M["configs"]) <= 24 and 1 <= len(M["workloads"]) <= 24
    assert 1 <= len(M["end_to_end"]) <= 16 and 1 <= len(M["per_layer"]) <= 128
    assert os.path.getsize(os.path.join(manifest.ROOT, "BENCHMARK.json")) <= 64 << 10


def test_a_full_check_fits_with_24_cells():
    assert 2 + 14 * 24 * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_entry_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_names_units_and_texts():
    names = [x["name"] for x in M["configs"]] + [x["name"] for x in M["workloads"]] + [x["name"] for x in all_metrics()]
    for n in names + [w["config"] for w in M["workloads"]] + [w["traffic"] for w in M["workloads"]]:
        assert NAME.match(n), n
    for group in (M["configs"], M["workloads"], all_metrics()):
        assert len({x["name"] for x in group}) == len(group)
    for m in all_metrics():
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in M["per_layer"]:
        assert TEXT.match(m["layer"])
    for x in M["configs"] + M["workloads"]:
        assert TEXT.match(x["why"])
    for c in M["configs"]:
        assert TEXT.match(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k) for k in c["reduced"])


def test_bounds():
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert [m["bound"] for m in M["end_to_end"] if m["name"] == "setup_s"] == [0.25]


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    for w in M["workloads"]:
        assert w["chips"] in (1, 4)
        cell = manifest.cell(M, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert cell.per_layer, w["name"]
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", [w["name"] for w in M["workloads"]]):
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(M["workloads"]) // 4)


def test_every_config_has_a_cell_and_one_file():
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    files = [c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files)
    for c in M["configs"]:
        path = os.path.join(manifest.ROOT, c["file"])
        assert os.path.isfile(path) and c["file"].startswith(tuple(p + "/" for p in M["paths"]))
        conf = json.load(open(path))
        assert conf["source"] == c["source"]
        assert set(conf["reduced"]) == set(c["reduced"])


def test_the_files_found_by_name_exist():
    for w in M["workloads"]:
        traffic = json.load(open(manifest.traffic_path(w["traffic"])))
        assert os.path.isfile(os.path.join(manifest.BENCH_DIR, "kinds", traffic["kind"] + ".py"))
    for m in M["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def _copy(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(manifest.BENCH_DIR, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(manifest.ROOT, "slacken_tpu_torch"), root / "slacken_tpu_torch")
    return root


def test_a_cell_config_mix_and_metric_are_added_as_new_files_only(tmp_path):
    root = _copy(tmp_path)
    before = {p: open(p, "rb").read() for p in map(str, (root / "portbench").rglob("*")) if os.path.isfile(p)}
    conf = json.load(open(root / "portbench/configs/marine.json"))
    conf["library"].update(size_median_bp=20_000, size_min_bp=10_000, size_max_bp=40_000)
    conf["taxonomy"]["n_species"] = 16
    conf["reads"]["outside_bp"] = 10_000
    conf["source"] = "a dummy deployment of the test"
    (root / "portbench/configs/dummy.json").write_text(json.dumps(conf))
    mix = json.load(open(root / "portbench/traffic/reports.json"))
    mix.update(pairs_per_sample=200, thresholds=[0.0, 0.5])
    (root / "portbench/traffic/dummy_mix.json").write_text(json.dumps(mix))
    (root / "portbench/layer_metrics/dummy_metric.py").write_text("def read(context):\n    return None\n")
    m = json.load(open(root / "BENCHMARK.json"))
    m["configs"].append({"name": "dummy", "source": "a dummy deployment of the test",
                         "file": "portbench/configs/dummy.json", "reduced": ["taxonomy"], "why": "a test"})
    m["workloads"].append({"name": "dummy.mix", "config": "dummy", "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    for e in m["end_to_end"]:
        e.get("workloads", []).append("dummy.mix")
    m["per_layer"].append({"name": "dummy_metric", "unit": "%", "better": "higher", "source": "host_clock",
                           "layer": "device", "moves": "window_peak_gib", "workloads": ["dummy.mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    code = ("import sys, time, json; sys.path.insert(0, %r)\n"
            "from portbench.pbcore import cli, manifest\n"
            "assert manifest.reader('dummy_metric')({}) is None\n"
            "sys.exit(cli.main(['--workload', 'dummy.mix', '--seed', '5', '--seconds', '1'], time.perf_counter(),"
            " device='cpu'))" % str(root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and {"window_peak_gib", "setup_s"} <= set(result["metrics"])
    after = {p: open(p, "rb").read() for p in before}
    assert after == before
