"""On the card (gpu marker; each test skips without one): every cell at a
test's size agrees with the reference through the CUDA kernels, its
control does not, and a traced run reads its per-layer metrics from the
profiler's trace. Run on the chip:

    python -m pytest -o addopts="" -m gpu portbench/tests
"""

import pytest

from portbench import control
from portbench.tests.conftest import ALL_CELLS, run_tiny

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_port_agrees_on_the_card(cell, cuda):
    r = run_tiny(cell, device=cuda, seconds=2.0)
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["memory_peak_bytes"] > 0


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_the_control_is_not_correct_on_the_card(cell, cuda):
    r = run_tiny(cell, device=cuda, seed=5, control=control.DROP_BITS)
    assert r["correct"] is False


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_a_traced_run_reads_the_trace(cell, cuda):
    r = run_tiny(cell, device=cuda, seconds=3.0, trace=True)
    assert r["correct"] is True
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert r["breakdown"]["device_ops"]
    for name, m in r["metrics"].items():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 100, (name, m)
