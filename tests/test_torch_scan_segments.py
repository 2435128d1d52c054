"""The scan of long rows cut into segments, on the CPU: each segment's warp
modelled by the plain twin on the segment's slice (the warm-up chunk of 128
positions before it, and the k - 1 bases after it that its last windows
reach), the stitch inside the launch by its plain twin
`minimizers.stitch_segments` and, chunk by chunk as the kernel's last warp
walks a row, by `stitch_row_model`; the result held
at tolerance 0 to the whole-row twin, to the JAX package's
window_minimizers and, on one row, to tests/oracle.py's spans. The rows
(`workloads.segment_rows`) put N runs over whole segments, first valid
windows at segment starts, all-invalid rows and a short last segment in the
way. The CUDA kernels meet the same rows in tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

import oracle
from slacken_tpu.ops import minimizers as jmin
from slacken_tpu.ops import u64, u128
from slacken_tpu_torch import workloads
from slacken_tpu_torch.ops import cuda_kernels, minimizers

torch.set_num_threads(1)

CHUNK = cuda_kernels.CHUNK
#: the SMs of an H100 SXM, whose warps the segment lengths below are chosen for
H100_SMS = 132


def hand_made_summaries():
    """(minimizer [2, 1024, 2], distinct, summary [2, 8, 4]) whose stitch
    clears distinct[0, 900] with two limbs, and distinct[1, 400] too when
    only the lo64 limb is compared (a narrow m)."""
    b, L, nseg = 2, 1024, 8
    minimizer = torch.zeros((b, L, 2), dtype=torch.int64)
    distinct = torch.ones((b, L), dtype=torch.bool)
    summary = torch.zeros((b, nseg, 4), dtype=torch.int64)
    summary[:, :, 1] = -1

    def segment(r, j, has, first=-1, last=(0, 0)):
        summary[r, j] = torch.tensor([has, -1 if first < 0 else r * L + first, *last])

    minimizer[0, 700] = torch.tensor([3, 9])
    segment(0, 1, 1, last=(3, 9))
    segment(0, 2, 1, last=(3, 8))  # the nearest holder: lo differs, nothing cleared
    segment(0, 5, 1, first=700, last=(1, 1))
    minimizer[0, 900] = torch.tensor([1, 1])
    segment(0, 7, 1, first=900)  # walks over segment 6 back to 5: equal, cleared
    segment(1, 0, 1, first=10, last=(2, 2))  # a row's first segment: row 0 ended on (0, 0), ignored
    minimizer[1, 400] = torch.tensor([7, 2])
    segment(1, 3, 1, first=400)  # segment 0's (2, 2): lo64 equal, hi64 not
    return minimizer, distinct, summary


def pass1_model(codes, mp, segment, lut=None):
    """What the scan kernel's first pass writes for rows cut into segments:
    (WindowMinimizers, summary int64 [B, nseg, 4])."""
    codes = torch.from_numpy(codes)
    b, L = codes.shape
    nseg = -(-L // segment)
    whole = minimizers.window_minimizers(codes, mp, lut)
    out = [torch.empty_like(x) for x in whole]
    summary = torch.zeros((b, nseg, 4), dtype=torch.int64)
    rows = torch.arange(b)
    for j in range(nseg):
        s0, s1 = j * segment, min(L, (j + 1) * segment)
        lo, hi = max(0, s0 - CHUNK), min(L, s1 + mp.k - 1)
        got = minimizers.window_minimizers(codes[:, lo:hi], mp, lut)
        for o, g in zip(out, got):
            o[:, s0:s1] = g[:, s0 - lo : s1 - lo]
        valid = got.valid[:, s0 - lo : s1 - lo]
        has = valid.any(1)
        first = torch.where(has, valid.int().argmax(1), 0)
        last = s1 - s0 - 1 - torch.where(has, valid.flip(1).int().argmax(1), 0)
        reach = got.valid[:, : s0 - lo].any(1)  # a valid window in the warm-up chunk
        summary[:, j, 0] = has.long()
        summary[:, j, 1] = torch.where(has & ~reach & (j > 0), rows * L + s0 + first, -1)
        last_min = got.minimizer[rows, s0 - lo + last].reshape(b, -1)
        summary[:, j, 4 - last_min.shape[1]:] = last_min
    return minimizers.WindowMinimizers(*out), summary


def assert_jax_agrees(codes, mp, got, lut=None):
    want = jmin.window_minimizers(codes, jmin.MinimizerParams(mp.k, mp.m, mp.spaces, canonical=mp.canonical),
                                  None if lut is None else lut.numpy())
    valid = np.asarray(want.valid)
    if mp.wide:
        wmin = np.stack(u128.to_u64_pair(want.minimizer), -1).view(np.int64)
    else:
        wmin = u64.to_ints(want.minimizer).astype(np.int64)
    assert np.array_equal(got.valid.numpy(), valid)
    assert np.array_equal(got.minimizer.numpy()[valid], wmin[valid])
    assert np.array_equal(got.span_start.numpy(), np.asarray(want.span_start))
    assert np.array_equal(got.distinct.numpy(), np.asarray(want.distinct))


def assert_oracle_agrees(codes, mp, got, row=2):
    spans = oracle.spans([int(c) for c in codes[row]], mp.k, mp.m, mp.spaces, canonical=mp.canonical)
    starts = np.flatnonzero(got.span_start[row].numpy())
    assert list(starts) == [sp[0] for sp in spans]
    assert list(got.distinct[row].numpy()[starts]) == [sp[3] for sp in spans]


@pytest.mark.parametrize("kms,canonical,segment,table", [
    ((35, 31, 7), True, 128, None),       # Kraken 2's default, the shortest segment
    ((35, 31, 7), True, 384, None),       # a last segment shorter than the others
    ((31, 31, 0), False, 256, None),      # W = 1
    ((151, 31, 0), True, 128, None),      # k - m = 120: windows that reach into the next chunk
    ((21, 15, 3), True, 512, None),
    ((12, 6, 1), True, 256, "random"),    # a rank table
    ((50, 45, 7), True, 128, None),       # wide
    ((63, 63, 0), False, 256, None),      # wide, W = 1
    ((183, 63, 31), True, 384, None),     # wide, k - m = 120
])
def test_segments_stitched_equal_the_whole_row(kms, canonical, segment, table):
    rng = np.random.default_rng(kms[0] * 1000 + segment)
    mp = minimizers.MinimizerParams(*kms, canonical=canonical)
    lut = None if table is None else torch.from_numpy(rng.permutation(1 << (2 * mp.m)).astype(np.int32))
    codes = workloads.segment_rows(rng, segment, mp.k)
    whole = minimizers.window_minimizers(torch.from_numpy(codes), mp, lut)
    seg, summary = pass1_model(codes, mp, segment, lut)
    for name in ("minimizer", "valid", "span_start"):
        assert torch.equal(getattr(seg, name), getattr(whole, name)), name
    # pass 1 alone writes distinct = 1 where the stitch must clear it: the
    # rows are made so that this happens
    wrong = seg.distinct & ~whole.distinct
    assert wrong.any() and torch.equal(seg.distinct | whole.distinct, seg.distinct)
    stitched = minimizers.stitch_segments(seg.minimizer, seg.distinct, summary)
    assert torch.equal(stitched, whole.distinct)
    got = minimizers.WindowMinimizers(seg.minimizer, seg.valid, seg.span_start, stitched)
    assert_jax_agrees(codes, mp, got, lut)
    if table is None:
        assert_oracle_agrees(codes, mp, got)



@pytest.mark.parametrize("kms", [(35, 31, 7), (50, 45, 7), (183, 63, 31)])
def test_carry_rows_give_the_stitch_work(kms):
    """workloads.carry_rows, which chip_smoke.py times the stitch on at
    bracken's shape: pass 1 leaves distinct = 1 at each repeated run's end,
    where the stitch clears it, and the result is the whole row's."""
    mp = minimizers.MinimizerParams(*kms)
    segment = 256
    codes = workloads.carry_rows(np.random.default_rng(kms[0]), (2, 16 * segment), segment, mp.k)
    whole = minimizers.window_minimizers(torch.from_numpy(codes), mp)
    seg, summary = pass1_model(codes, mp, segment)
    cleared = [(r, j * segment) for r in range(2) for j in range(3, 16, 3) if (j // 3 + r) % 3 < 2]
    assert torch.equal(torch.nonzero(seg.distinct & ~whole.distinct), torch.tensor(cleared))
    assert torch.equal(minimizers.stitch_segments(seg.minimizer, seg.distinct, summary), whole.distinct)
    with pytest.raises(ValueError, match="k \\+ 64"):
        workloads.carry_rows(np.random.default_rng(0), (1, 4096), 128, 65)

def stitch_row_model(minimizer, distinct, summary):
    """kernels/scan.cu's stitch_row for every row, lane by lane: the row's
    segments 32 at a time, each needing segment's nearest earlier holder the
    highest holder among the lanes below, else the carry from the chunks
    before. Returns a new distinct."""
    out = distinct.clone().view(-1)
    limbs = minimizer.reshape(-1, 1 if minimizer.dim() == 2 else 2)
    b, nseg, _ = summary.shape
    for r in range(b):
        carry = -1
        for c in range(0, nseg, 32):
            lanes = range(c, min(c + 32, nseg))
            holders = [j for j in lanes if summary[r, j, 0]]
            for j in lanes:
                o = int(summary[r, j, 1])
                lower = [h for h in holders if h < j]
                before = lower[-1] if lower else carry
                if o >= 0 and before >= 0 and torch.equal(limbs[o], summary[r, before, 4 - limbs.shape[1]:]):
                    out[o] = False
            if holders:
                carry = holders[-1]
    return out.view(distinct.shape)


@pytest.mark.parametrize("kms,segments", [((35, 31, 7), 40), ((50, 45, 7), 70), ((183, 63, 31), 34)])
def test_stitch_row_model_equals_the_twin(kms, segments):
    """The fused stitch's algorithm (its chunks of 32 segments and the carry
    between them) on carry_rows of more than 32 segments a row, whose walks
    cross chunk boundaries, and on the hand-made summaries: the twin's
    result, and the whole row's."""
    mp = minimizers.MinimizerParams(*kms)
    segment = 256
    codes = workloads.carry_rows(np.random.default_rng(segments), (3, segments * segment), segment, mp.k)
    seg, summary = pass1_model(codes, mp, segment)
    want = minimizers.window_minimizers(torch.from_numpy(codes), mp).distinct
    # a first window that needs the carry, cleared, whose nearest holder lies in the chunk before
    crossing = [(r, j) for r in range(3) for j in range(32, segments) if j % 32 == 1 and summary[r, j, 1] >= 0
                and not summary[r, j - 1, 0] and summary[r, j - 2, 0]]
    assert any(not want.view(-1)[summary[r, j, 1]] for r, j in crossing)
    assert torch.equal(stitch_row_model(seg.minimizer, seg.distinct, summary), want)
    assert torch.equal(minimizers.stitch_segments(seg.minimizer, seg.distinct, summary), want)
    assert minimizers.carried(seg.minimizer, summary).numel() == int((seg.distinct & ~want).sum())
    minimizer, distinct, summary = hand_made_summaries()
    for mn in (minimizer, minimizer[..., 1].contiguous()):
        assert torch.equal(stitch_row_model(mn, distinct, summary), minimizers.stitch_segments(mn, distinct, summary))


def test_stitch_walks_back_over_segments_without_valid_windows():
    """Hand-made summaries: the walk stops at the nearest segment that holds
    a valid window, compares both limbs, never crosses into another row,
    and leaves alone a segment that needs no carry."""
    minimizer, distinct, summary = hand_made_summaries()
    got = minimizers.stitch_segments(minimizer, distinct, summary)
    assert torch.equal(torch.nonzero(~got), torch.tensor([[0, 900]]))
    # narrow: one limb, compared with the summary's lo64
    narrow = minimizer[..., 1].contiguous()
    got = minimizers.stitch_segments(narrow, distinct, summary)
    assert torch.equal(torch.nonzero(~got), torch.tensor([[0, 900], [1, 400]]))


@pytest.mark.parametrize("rows,L,want", [
    (32768, 128, 128), (16384, 264, 264), (8192, 4096, 4096),  # classify and build batches: a warp a row
    (4, 1 << 20, 2048), (9, 1 << 20, 4480), (1, 1 << 20, 2048),  # bracken's fragment rows
    (100, 128, 128), (3, 1024, 1024),  # few short rows: no segment below 2,048
    (64, 65536, 2048),
])
def test_segment_length(rows, L, want):
    warps = cuda_kernels.SCAN_WARPS_PER_SM * H100_SMS
    S = cuda_kernels.segment_length(rows, L, warps)
    assert S == want
    assert S == L or (S % CHUNK == 0 and S >= cuda_kernels.MIN_SEGMENT)
    if cuda_kernels.MIN_SEGMENT < S < L:  # as many warps as the card wants, no more segments than that needs
        assert rows * -(-L // S) >= warps > rows * -(-L // (S + CHUNK))


def test_segmented_scan_refuses_what_it_does_not_take():
    mp = minimizers.MinimizerParams()
    packed = torch.zeros((2, 256), dtype=torch.uint8)
    valid = torch.zeros((2, 128), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_kernels.window_minimizers_cuda(packed, valid, mp, _segment=128)
