"""No module of the benchmark imports JAX, the JAX package, bench or
scale_bench (whole top-level names: the port's name begins with the JAX
package's), and the plain reference imports nothing of the port."""

import ast
import glob
import os
import subprocess
import sys

import pytest

from portbench.pbcore import guard, manifest

BENCH = manifest.BENCH_DIR


def imported_top_levels(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            names.add(node.args[0].value.split(".")[0])
    return names


SOURCES = sorted(glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, BENCH))
def test_no_forbidden_imports(path):
    names = imported_top_levels(path)
    assert not names & guard.FORBIDDEN, f"{path} imports {sorted(names & guard.FORBIDDEN)}"
    if os.sep + "reference" + os.sep in path:
        assert "slacken_tpu_torch" not in names, f"the reference {path} imports the port"


def test_whole_name_comparison():
    assert guard.top_level(["slacken_tpu_torch.classify", "benchmark_x", "jaxtyping"]) & guard.FORBIDDEN == set()
    assert guard.top_level(["slacken_tpu.index", "jax.numpy"]) & guard.FORBIDDEN == {"slacken_tpu", "jax"}


def test_modules_loaded_by_a_run_hold_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.pbcore.harness, portbench.pbcore.cli, portbench.control\n"
            "import portbench.kinds.classify, portbench.kinds.build, portbench.kinds.bracken\n"
            "import slacken_tpu_torch.classify, slacken_tpu_torch.index, slacken_tpu_torch.bracken\n"
            "from portbench.pbcore import guard, manifest\n"
            "[manifest.readers(manifest.load()['per_layer'])]\n"
            "print(guard.loaded())" % manifest.ROOT)
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
