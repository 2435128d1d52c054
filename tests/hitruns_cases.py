"""Shared cases of the hit-runs reduction: the row shapes and the hand-made
edge rows that the CPU tests (test_torch_hitruns.py) and the gpu tests
(test_torch_gpu.py) both run, and `warp_walk`, a model in numpy of the CUDA
kernel's walk (kernels/hitruns.cu): 8, 16 or 32 lanes a row, 16 positions a
lane as bit masks, a chunk of a row's lanes a step, ballots as bit masks,
shuffles as list indexing, the segment scan of the lanes' packed counts as
a running sum, the ambiguity test as masks over 32-bit validity words. The
CPU tests hold the model to the twin, the gpu tests the kernel."""

import numpy as np

from slacken_tpu_torch import workloads

#: (rows, width, k, paired) of the CPU cases: three widths, two k, both kinds
SHAPES = [(rows, width, k, paired) for width, rows in ((128, 40), (256, 24), (1024, 12))
          for k in (35, 50) for paired in (False, True)]

#: (width, k) of workloads.hit_runs_edge_rows
EDGE_SHAPES = workloads.HIT_RUNS_EDGE_SHAPES

PER_LANE = workloads.HIT_RUNS_PER_LANE
LANE_BITS = (1 << PER_LANE) - 1
_INT_MIN = -(2**31)


def edge_rows(width, k):
    return workloads.hit_runs_edge_rows(width, k, seed=width + k)


def _below(b):
    """A lane's positions j < b as a bit mask."""
    return 0 if b <= 0 else LANE_BITS if b >= PER_LANE else (1 << b) - 1


def _bits32(bits, b):
    """32 validity bits of the row from bit b (past its words clear)."""
    w = b >> 5
    lo = int(bits[w]) if w < len(bits) else 0
    hi = int(bits[w + 1]) if w + 1 < len(bits) else 0
    return ((hi << 32 | lo) >> (b & 31)) & 0xFFFFFFFF


def _all_invalid16(bits, p0, k):
    """The lane's positions whose k chars are all invalid, as the kernel
    finds them: doubling steps below 16 chars, else the lane's own chars from
    j, the chars p0 + 16 to p0 + k, and j chars from p0 + k."""
    if k < PER_LANE:
        r, have = ~_bits32(bits, p0) & 0xFFFFFFFF, 1
        while 2 * have <= k:
            r &= r >> have
            have *= 2
        return r & (r >> (k - have)) & LANE_BITS
    for q in range(p0 + PER_LANE, p0 + k):
        if int(bits[q >> 5]) >> (q & 31) & 1:
            return 0
    head_valid = _bits32(bits, p0) & LANE_BITS
    head = LANE_BITS & ~((2 << (head_valid.bit_length() - 1)) - 1) if head_valid else LANE_BITS
    tail = _bits32(bits, p0 + k)
    tail_invalid = (tail & -tail).bit_length() - 1  # -1: no valid char in 32
    return head & (LANE_BITS if tail_invalid < 0 else _below(tail_invalid + 1))


def _popc(x):
    return bin(x).count("1")


def _lane(wt_row, bits, split, length, k, p0):
    """One lane's 16 positions from p0: (values with ambiguous windows at
    -1, non-gap mask, mate-2 mask)."""
    L, paired = len(wt_row), split >= 0
    t = [int(wt_row[p]) if p < L else -3 for p in range(p0, p0 + PER_LANE)]
    ng = sum(int(x != -3) << j for j, x in enumerate(t))
    m2 = LANE_BITS & ~_below(split + 1 - p0) if paired else 0
    m_end0, m_end1 = min(split if paired else length, L), min(length, L)
    amb = (_below(m_end0 - k + 1 - p0) | (m2 & _below(m_end1 - k + 1 - p0))) & ~ng
    if amb:
        amb &= _all_invalid16(bits, p0, k)
    t = [-1 if amb >> j & 1 else x for j, x in enumerate(t)]
    return t, ng | amb, m2


def warp_walk(wt, valid, splits, row_lens, k, cap):
    """hit_runs_kernel's bundle, one row at a time as its segment of lanes
    computes it."""
    rows, L = wt.shape
    out = np.empty((rows, cap + cap // 2 + 3), np.int64)
    words = (L + 31) // 32
    G = workloads.hit_runs_lanes(L)
    for r in range(rows):
        raw = np.zeros(4 * words, np.uint8)
        raw[: L // 8] = valid[r]
        bits = raw.view("<u4")
        split, length = int(splits[r]), int(row_lens[r])
        runs = nongaps = mate2 = 0
        carry = None  # the last non-gap (value, position) of the chunks before
        start, value = {}, {}
        for c in range(0, L, PER_LANE * G):
            lanes = [_lane(wt[r], bits, split, length, k, c + PER_LANE * sl) for sl in range(G)]
            last = [(t[ng.bit_length() - 1], c + PER_LANE * sl + ng.bit_length() - 1) if ng else None
                    for sl, (t, ng, _) in enumerate(lanes)]
            has = sum(int(ng != 0) << sl for sl, (_, ng, _) in enumerate(lanes))
            starts, counts = [], []
            for sl, (t, ng, m2) in enumerate(lanes):
                below = has & ((1 << sl) - 1)
                prev = last[below.bit_length() - 1] if below else carry
                v = None if prev is None else prev[0]
                diff = 0
                for j in range(PER_LANE):
                    diff |= int(t[j] != v) << j
                    v = t[j] if ng >> j & 1 else v
                st = ng & diff
                if prev is None:
                    st |= ng & -ng  # the row's first non-gap
                ng2 = ng & m2
                if ng2:
                    first2 = ng2 & -ng2
                    if ng & (first2 - 1) or (prev is not None and prev[1] <= split):
                        st |= first2
                starts.append(st)
                counts.append(_popc(ng) | _popc(st) << 10 | _popc(ng2) << 20)
            incl = np.cumsum(counts)  # the segment scan, inclusive
            for sl, (t, ng, m2) in enumerate(lanes):
                excl = int(incl[sl]) - counts[sl]
                i, place = runs + (excl >> 10 & 0x3FF), nongaps + (excl & 0x3FF)
                for j in range(PER_LANE):
                    if starts[sl] >> j & 1:
                        if i <= cap:
                            start[i] = place + _popc(ng & ((1 << j) - 1))
                        if i < cap:
                            value[i] = (((t[j] + 2) << 1) | (m2 >> j & 1)) & 0xFFFFFFFF
                        i += 1
            total = int(incl[-1])
            runs += total >> 10 & 0x3FF
            nongaps += total & 0x3FF
            mate2 += total >> 20
            if has:
                carry = last[has.bit_length() - 1]
        counts = [((start[j + 1] if j + 1 < runs else nongaps) - start[j]) if j < runs else 0 for j in range(cap)]
        out[r, :cap] = [value[j] if j < runs else _INT_MIN & 0xFFFFFFFF for j in range(cap)]
        out[r, cap : cap + cap // 2] = [counts[2 * j] | (counts[2 * j + 1] << 16) for j in range(cap // 2)]
        out[r, -3:] = runs, nongaps - mate2, mate2
    return out.astype(np.uint32).view(np.int32)
