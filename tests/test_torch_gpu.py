"""The CUDA kernels against their plain PyTorch twins, on the card. Marked
`gpu`: each test skips without CUDA. The repository's conftest imports JAX,
which the GPU host lacks, so run these there with

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from slacken_tpu_torch.ops import cuda_kernels, encode, lookup, minimizers

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(64, 128), (8, 1024), (3, 136)])
@pytest.mark.parametrize("kms", [(35, 31, 7), (21, 15, 3), (31, 31, 0)])
def test_scan_kernel_matches_twin(cuda, shape, kms):
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, shape).astype(np.uint8)
    codes[rng.random(shape) < 0.05] = encode.INVALID
    packed, valid = (torch.from_numpy(a).to(cuda) for a in encode.pack_2bit(codes))
    mp = minimizers.MinimizerParams(*kms)
    before = cuda_kernels.LAUNCHES["scan"]
    got = minimizers.window_minimizers_packed(packed, valid, mp)
    assert cuda_kernels.LAUNCHES["scan"] == before + 1
    want = minimizers.window_minimizers(torch.from_numpy(codes), mp)
    v = want.valid
    assert torch.equal(got.valid.cpu(), v)
    assert torch.equal(got.span_start.cpu(), want.span_start)
    assert torch.equal(got.distinct.cpu(), want.distinct)
    assert torch.equal(got.minimizer.cpu()[v], want.minimizer[v])


@pytest.mark.parametrize("n", [1, 127, 128, 129, 100_000])
def test_probe_kernel_matches_twin(cuda, n):
    rng = np.random.default_rng(n)
    keys = np.unique(rng.integers(0, 1 << 62, 2 * n, dtype=np.int64))[:n]
    taxa = rng.integers(1, 1 << 20, len(keys)).astype(np.int32)
    q = np.concatenate([keys, rng.integers(-(1 << 63), (1 << 63) - 1, 5000, dtype=np.int64)])
    k_d, t_d, q_d = (torch.from_numpy(a).to(cuda) for a in (keys, taxa, q))
    got = lookup.probe(k_d, t_d, lookup.build_fence(k_d), q_d)
    want = lookup.lookup_taxa(torch.from_numpy(keys), torch.from_numpy(taxa), torch.from_numpy(q))
    assert torch.equal(got.cpu(), want)
