"""The port runs where JAX is absent: no slacken_tpu_torch module (nor
chip_smoke.py) imports jax, and the device is chosen explicitly, never
falling back to the CPU."""

import os
import subprocess
import sys

import pytest
import torch

import slacken_tpu_torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPORT_ALL = """
import pkgutil, importlib, sys
import slacken_tpu_torch
names = [m.name for m in pkgutil.walk_packages(slacken_tpu_torch.__path__, "slacken_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert len(names) >= 10, names
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert not bad, bad
print("imported", len(names))
"""


def test_no_module_imports_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("imported")


def test_get_device_never_falls_back(monkeypatch):
    assert slacken_tpu_torch.get_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        slacken_tpu_torch.get_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        slacken_tpu_torch.get_device("cuda:0")


def test_cli_refuses_cuda_without_cuda(monkeypatch, tmp_path):
    from slacken_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["classify", "-i", str(tmp_path), "-o", str(tmp_path / "o"), "--no-detailed"])
