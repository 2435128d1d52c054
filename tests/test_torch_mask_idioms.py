"""The plain PyTorch twins of the five mask-idiom kernels against the TPU
bodies of `exp_pallas_probe` (k_select, k_astype, k_concat, k_carry and
k_sum_bool in the JAX package's TPU experiment script), run through
pl.pallas_call(..., interpret=True) on the CPU. The bodies are closures
there, so they are restated here with the array shape as a parameter. Exact
(tolerance 0: int32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from slacken_tpu_torch import diagnostics
from slacken_tpu_torch.ops import cuda_kernels, mask_idioms

torch.set_num_threads(1)


def k_select(x_ref, o_ref):
    m = x_ref[:] > 64
    o_ref[:] = jnp.where(m, jnp.int32(1), jnp.int32(0))


def k_astype(x_ref, o_ref):
    o_ref[:] = (x_ref[:] > 64).astype(jnp.int32)


def k_concat(x_ref, o_ref):
    m = x_ref[:] > 64
    z = jnp.zeros((m.shape[0], 1), bool)
    m2 = jnp.concatenate([m[:, 1:], z], axis=-1)
    o_ref[:] = jnp.where(m & m2, jnp.int32(1), jnp.int32(0))


def k_carry(x_ref, o_ref):
    m = x_ref[:] > 64
    v = x_ref[:]
    z = jnp.zeros((v.shape[0], 16), x_ref.dtype)
    zb = jnp.zeros((v.shape[0], 16), bool)
    pv = jnp.concatenate([z, v[:, :-16]], axis=-1)
    pm = jnp.concatenate([zb, m[:, :-16]], axis=-1)
    take = (~m) & pm
    o_ref[:] = jnp.where(take, pv, v)


def k_sum_bool(x_ref, o_ref):
    m = x_ref[:] > 64
    s = jnp.sum(jnp.where(m, 1, 0))
    o_ref[:] = x_ref[:] + s


BODIES = {"select": k_select, "astype": k_astype, "concat": k_concat, "carry": k_carry,
          "sum_bool": k_sum_bool}


def _input(kind):
    if kind == "long":  # more elements than one wave of the sum_bool kernel's resident grid, an odd tail
        return np.random.default_rng(5).integers(0, 129, (1201, 1001)).astype(np.int32)
    if kind == "ramp":  # the TPU experiment's own input
        return np.arange(8 * 128, dtype=np.int32).reshape(8, 128)
    rng = np.random.default_rng(11)
    if kind == "tall":
        return rng.integers(0, 129, (40, 128)).astype(np.int32)
    # 48 columns, values either side of the int32 range's ends
    x = rng.integers(0, 129, (24, 48)).astype(np.int32)
    x[::3, ::5] = np.iinfo(np.int32).max
    x[1::3, ::7] = np.iinfo(np.int32).min
    return x


def test_names_agree():
    assert tuple(BODIES) == tuple(mask_idioms.PLAIN) == cuda_kernels.MASK_IDIOMS
    assert set(cuda_kernels.MASK_IDIOMS) <= set(cuda_kernels.LAUNCHES)


@pytest.mark.parametrize("kind", ["ramp", "tall", "wide-range", "long"])
@pytest.mark.parametrize("name", list(BODIES))
def test_twin_matches_tpu_body(name, kind):
    x = _input(kind)
    want = np.asarray(pl.pallas_call(
        BODIES[name], out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int32), interpret=True)(jnp.asarray(x)))
    before = dict(cuda_kernels.LAUNCHES)
    got = mask_idioms.run(name, torch.from_numpy(x))  # a CPU tensor: the twin
    assert got.dtype == torch.int32 and tuple(got.shape) == x.shape
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(mask_idioms.PLAIN[name](torch.from_numpy(x)).numpy(), want)
    assert cuda_kernels.LAUNCHES == before  # no kernel was launched


def test_sum_bool_wraps_like_int32():
    x = torch.full((8, 16), 100, dtype=torch.int32)
    x[0, 0] = np.iinfo(np.int32).max
    got = mask_idioms.run("sum_bool", x)
    assert int(got[0, 0]) == np.iinfo(np.int32).min + 127 and int(got[1, 1]) == 228


def test_sum_bool_is_one_cooperative_kernel():
    """The CUDA source holds one kernel for k_sum_bool, launched cooperatively
    with a grid barrier: no memset, no separate count and add kernels."""
    import os
    import re

    path = os.path.join(os.path.dirname(cuda_kernels.__file__), "kernels", "mask_idioms.cu")
    with open(path) as f:
        src = re.sub(r"//[^\n]*", "", f.read())
    assert "cudaLaunchCooperativeKernel" in src and "grid.sync()" in src
    assert "cudaOccupancyMaxActiveBlocksPerMultiprocessor" in src
    assert "cudaMemset" not in src and "count_kernel" not in src
    assert len(re.findall(r"__global__", src)) == 5
    assert src.count("<<<") == 4  # the other four idioms launch plainly


def test_shifts_stay_inside_a_row():
    """The idioms shift within a row: a flat shift would leak row r+1's
    first column into row r's last (concat) or row r-1's tail into row r's
    head (carry)."""
    x = torch.full((4, 32), 100, dtype=torch.int32)
    assert mask_idioms.run("concat", x)[:, -1].tolist() == [0, 0, 0, 0]
    x = torch.zeros((4, 32), dtype=torch.int32)
    x[:, 16:] = 100
    assert torch.equal(mask_idioms.run("carry", x), x)


@pytest.mark.parametrize("name", list(BODIES))
def test_cuda_wrapper_never_runs_the_twin(name):
    """On a tensor that is not on the card the CUDA wrapper raises."""
    x = torch.zeros((8, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_kernels.mask_idiom_cuda(name, x)
    assert cuda_kernels.LAUNCHES[name] == 0


def test_kernel_probe_on_the_cpu_and_default_device(monkeypatch, capsys):
    assert diagnostics.kernel_probe("cpu") == {name: "ok" for name in BODIES}
    assert diagnostics.main(["--device", "cpu"]) == 0
    assert '"sum_bool": "ok"' in capsys.readouterr().out
    monkeypatch.setitem(mask_idioms.PLAIN, "carry", lambda x: x + 1)
    assert diagnostics.kernel_probe("cpu")["carry"] == "ok"  # twin against itself
    monkeypatch.setattr(mask_idioms, "run", lambda name, x: x)
    assert diagnostics.kernel_probe("cpu")["carry"].startswith("mismatch at [8, 128]")
    assert diagnostics.main(["--device", "cpu"]) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        diagnostics.main([])
