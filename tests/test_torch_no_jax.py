"""The port runs where JAX and the JAX package are absent: no
slacken_tpu_torch module (nor chip_smoke.py) imports jax, slacken_tpu, the
bench scripts, or the repository's tests and scripts (the oracle and the
fuzz harness are the port's own copies), and the device is chosen
explicitly, never falling back to the CPU."""

import glob
import os
import re
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
assert len(names) >= 35 and "slacken_tpu_torch.ops.ordering" in names, names
assert "slacken_tpu_torch.dynamic" in names and "slacken_tpu_torch.stats" in names, names
assert "slacken_tpu_torch.ops.hitruns" in names, names
for name in ("bracken", "analysis.migration", "analysis.experiment", "download",
             "parallel", "parallel.mesh", "parallel.classifier", "parallel.multihost", "oracle", "fuzz"):
    assert "slacken_tpu_torch." + name in names, names
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "slacken_tpu", "bench", "scale_bench", "oracle",
                                    "oracle_fuzz", "tests", "scripts", "conftest")
             or m.startswith("test_"))
assert not bad, bad
print("imported", len(names))
"""


def test_no_module_imports_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("imported")


def test_no_source_names_the_jax_package():
    """No file of the port, nor chip_smoke.py or scan_timing.py, holds an
    import of jax, slacken_tpu, bench or scale_bench, nor of the tests' or
    the scripts' modules (not even inside a function)."""
    files = glob.glob(os.path.join(ROOT, "slacken_tpu_torch", "**", "*.py"), recursive=True)
    files += [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "scan_timing.py")]
    assert len(files) >= 36
    for name in (os.path.join("ops", "ordering.py"), os.path.join("ops", "hitruns.py"),
                 "dynamic.py", "stats.py", "bracken.py", "download.py",
                 os.path.join("analysis", "migration.py"), os.path.join("analysis", "experiment.py"),
                 os.path.join("parallel", "__init__.py"), os.path.join("parallel", "mesh.py"),
                 os.path.join("parallel", "classifier.py"), os.path.join("parallel", "multihost.py"),
                 "oracle.py", "fuzz.py"):
        assert os.path.join(ROOT, "slacken_tpu_torch", name) in files
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|slacken_tpu|bench|scale_bench|tests|scripts|oracle|"
                     r"oracle_fuzz|conftest|test_\w+)\b", re.M)
    for path in files:
        with open(path) as f:
            found = pat.search(f.read())
        assert found is None, (path, found.group(0))


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
