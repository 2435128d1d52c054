"""The port's minimizer scan (slacken_tpu_torch.ops.minimizers) against the
JAX package's window_minimizers and its Pallas scan kernel (interpret
mode), on the same numpy-made codes. Exact equality: minimizers where the
window is valid (values elsewhere are garbage in every implementation),
valid / span_start / distinct everywhere."""

import numpy as np
import pytest
import torch

from slacken_tpu.ops import minimizers as jmin
from slacken_tpu.ops import u64
from slacken_tpu.ops.pallas_kernels import window_minimizers_pallas
from slacken_tpu_torch.ops import cuda_kernels, encode, minimizers

torch.set_num_threads(1)

NARROW = [(35, 31, 7), (21, 15, 3)]


def _codes(rng, shape=(16, 256)):
    codes = rng.integers(0, 4, shape).astype(np.uint8)
    codes[rng.random(shape) < 0.04] = encode.INVALID
    codes[3, 40:90] = encode.INVALID  # an N run longer than k
    codes[5, 200:] = encode.INVALID  # padding
    codes[7, :] = codes[6, ::-1] ^ 3  # a reverse complement (N stays invalid below)
    codes[7][codes[6, ::-1] == encode.INVALID] = encode.INVALID
    return codes


def _assert_same(got, want_min, want_valid, want_start, want_distinct):
    valid = np.asarray(want_valid)
    assert np.array_equal(got.valid.numpy(), valid)
    assert np.array_equal(got.minimizer.numpy()[valid], want_min[valid])
    assert np.array_equal(got.span_start.numpy(), np.asarray(want_start))
    assert np.array_equal(got.distinct.numpy(), np.asarray(want_distinct))


def _port_params(k, m, s, canonical=True):
    return minimizers.MinimizerParams(k=k, m=m, spaces=s, canonical=canonical)


@pytest.mark.parametrize("kms", NARROW)
@pytest.mark.parametrize("canonical", [True, False])
def test_scan_matches_jax(rng, kms, canonical):
    codes = _codes(rng)
    want = jmin.window_minimizers(codes, jmin.MinimizerParams(*kms, canonical=canonical))
    wmin = u64.to_ints(want.minimizer).astype(np.int64)
    mp = _port_params(*kms, canonical=canonical)
    got = minimizers.window_minimizers(torch.from_numpy(codes), mp)
    _assert_same(got, wmin, want.valid, want.span_start, want.distinct)
    # the pipeline's entry point: pack_2bit's wire format through unpack_2bit
    packed, valid = encode.pack_2bit(codes)
    got_p = minimizers.window_minimizers_packed(torch.from_numpy(packed), torch.from_numpy(valid), mp)
    _assert_same(got_p, wmin, want.valid, want.span_start, want.distinct)


@pytest.mark.parametrize("kms", NARROW)
def test_scan_matches_pallas_interpret(rng, kms):
    codes = _codes(rng)
    want = window_minimizers_pallas(codes, jmin.MinimizerParams(*kms), 8, True)
    wmin = u64.to_ints(want.minimizer).astype(np.int64)
    got = minimizers.window_minimizers(torch.from_numpy(codes), _port_params(*kms))
    _assert_same(got, wmin, want.valid, want.span_start, want.distinct)


def test_unpack_2bit_inverts_pack(rng):
    codes = rng.integers(0, 5, (8, 64)).astype(np.uint8)
    packed, valid = encode.pack_2bit(codes)
    back = encode.unpack_2bit(torch.from_numpy(packed), torch.from_numpy(valid))
    assert back.dtype == torch.uint8
    assert np.array_equal(back.numpy(), codes)


@pytest.mark.parametrize("m,s", [(31, 7), (15, 3), (5, 0)])
def test_masks_match_jax(m, s):
    assert minimizers.space_mask_int(m, s) == jmin.space_mask_int(m, s)
    # the toggle mask truncated to 2m bits fits an int64
    assert minimizers.DEFAULT_TOGGLE_MASK & ((1 << (2 * m)) - 1) < 1 << 62


def test_priorities_stay_below_2_62(rng):
    codes = torch.from_numpy(rng.integers(0, 5, (4, 128)).astype(np.uint8))
    prio = minimizers.priorities(codes, _port_params(35, 31, 0))
    assert int(prio.min()) >= 0 and int(prio.max()) < 1 << 62


def test_cpu_tensors_never_reach_the_kernel(rng, monkeypatch):
    """The dispatcher takes the twin only for CPU tensors; the kernel
    wrapper itself refuses them."""
    cuda_kernels.reset_launch_counts()
    packed, valid = (torch.from_numpy(a) for a in encode.pack_2bit(_codes(rng)))
    minimizers.window_minimizers_packed(packed, valid, _port_params(35, 31, 7))
    assert cuda_kernels.LAUNCHES["scan"] == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_kernels.window_minimizers_cuda(packed, valid, _port_params(35, 31, 7))


def test_wide_minimizers_not_ported(rng):
    """Wide minimizers (m > 31), which the port used to refuse, equal the JAX
    package's in all four outputs (the name dates from the refusal;
    tests/test_torch_wide.py holds the other parameter sets). A rank table
    beside a wide m still raises."""
    from slacken_tpu.ops import u128

    codes = _codes(rng)
    want = jmin.window_minimizers(codes, jmin.MinimizerParams(40, 35, 0))
    hi, lo = u128.to_u64_pair(want.minimizer)
    got = minimizers.window_minimizers(torch.from_numpy(codes), _port_params(40, 35, 0))
    assert got.minimizer.shape == (16, 256, 2) and got.minimizer.dtype == torch.int64
    _assert_same(got, np.stack([hi, lo], -1).view(np.int64), want.valid, want.span_start, want.distinct)
    assert bool((got.minimizer[~got.valid] == -1).all())
    with pytest.raises(ValueError, match="m <= 15"):
        minimizers.window_minimizers(torch.from_numpy(codes), _port_params(40, 35, 0), torch.zeros(4, dtype=torch.int32))


def _bit_stream(row_bytes):
    """A little-endian byte row as one Python integer: byte i at bits 8i."""
    return int.from_bytes(row_bytes.tobytes(), "little")


def _reverse_pairs(s):
    """The 32 bit pairs of a 64-bit word in reverse order, as the scan kernel
    takes them: reverse all 64 bits, then swap the two bits of every pair."""
    r = int(f"{s:064b}"[::-1], 2)
    return ((r >> 1) & 0x5555555555555555) | ((r & 0x5555555555555555) << 1)


@pytest.mark.parametrize("length", [8, 128, 264, 1024])
@pytest.mark.parametrize("m", [1, 5, 16, 31])
def test_wire_format_is_the_mmer(rng, m, length):
    """What the CUDA scan kernel relies on: in pack_2bit's stream the 2m bits
    from bit 2p are the m-mer at p, its bases in reverse order. Complemented
    they are the reverse complement; with their bit pairs reversed, the
    forward m-mer; and a k-window is valid where k validity bits from bit p
    are all ones. Tolerance 0."""
    k = min(m + 4, length)
    codes = rng.integers(0, 4, (3, length)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.05] = encode.INVALID
    codes[1, length // 2 :] = encode.INVALID  # padding
    packed, valid = encode.pack_2bit(codes)
    c = torch.from_numpy(codes & 3).to(torch.int64)
    want_fwd = minimizers._mmers(c, m).numpy()
    want_rc = minimizers._revcomps(c, m).numpy()
    want_valid = minimizers.sliding_all(torch.from_numpy(codes < 4), k).numpy()
    mask = (1 << (2 * m)) - 1
    for r in range(codes.shape[0]):
        stream, vstream = _bit_stream(packed[r]), _bit_stream(valid[r])
        for p in range(length - m + 1):  # m-mers that end inside the row
            s = (stream >> (2 * p)) & mask
            assert ~s & mask == want_rc[r, p]
            assert _reverse_pairs(s) >> (64 - 2 * m) == want_fwd[r, p]
        got_valid = [(vstream >> p) & ((1 << k) - 1) == (1 << k) - 1 for p in range(length)]
        assert got_valid == want_valid[r].tolist()
