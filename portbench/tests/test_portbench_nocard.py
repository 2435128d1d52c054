"""Without a card, and in a checkout that holds only the benchmark, a run
fails and prints no result: no CPU number is ever written under a device
metric."""

import os
import shutil
import subprocess
import sys

from portbench.pbcore import manifest


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "marine.reports", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_card_no_result(monkeypatch):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(manifest.ROOT, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_only_the_benchmark_no_result(tmp_path):
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.BENCH_DIR, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_cli_refuses_without_a_card_before_any_work(monkeypatch, capsys):
    import time

    import torch

    from portbench.pbcore import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(["--workload", "strain.per_read", "--seed", "3", "--seconds", "1"], time.perf_counter())
    assert rc != 0 and capsys.readouterr().out == ""
