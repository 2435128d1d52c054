"""Shared cases of the hit-runs reduction: the row shapes that the CPU tests
(test_torch_hitruns.py) and the gpu tests (test_torch_gpu.py) both run, and
`warp_walk`, a model in numpy of the CUDA kernel's walk (kernels/hitruns.cu):
32-lane tiles, ballots as bit masks, shuffles as list indexing, the
validity test over 32-bit words. The CPU tests hold the model to the twin,
the gpu tests the kernel."""

import numpy as np

#: (rows, width, k, paired) of the CPU cases: three widths, two k, both kinds
SHAPES = [(rows, width, k, paired) for width, rows in ((128, 40), (256, 24), (1024, 12))
          for k in (35, 50) for paired in (False, True)]

_INT_MIN = -(2**31)


def _all_invalid(bits, p, k):
    end, q = p + k, p
    while q < end:
        off = q & 31
        n = min(32 - off, end - q)
        w = int(bits[q >> 5]) >> off
        if n < 32:
            w &= (1 << n) - 1
        if w:
            return False
        q += n
    return True


def _popc(x):
    return bin(x).count("1")


def warp_walk(wt, valid, splits, row_lens, k, cap):
    """hit_runs_kernel's bundle, one row at a time as its warp computes it."""
    rows, L = wt.shape
    out = np.empty((rows, cap + cap // 2 + 3), np.int64)
    words = (L + 31) // 32
    for r in range(rows):
        raw = np.zeros(4 * words, np.uint8)
        raw[: L // 8] = valid[r]
        bits = raw.view("<u4")
        split, length = int(splits[r]), int(row_lens[r])
        paired = split >= 0
        runs = nongaps = mate2 = 0
        last = None
        start, value = {}, {}
        for base in range(0, L, 32):
            ng, v, mate = 0, [-1] * 32, [0] * 32
            for lane in range(32):
                p = base + lane
                if p >= L:
                    continue
                t = int(wt[r, p])
                mate[lane] = int(paired and p > split)
                if t != -3:
                    ng |= 1 << lane
                    v[lane] = t
                else:
                    m_start = split + 1 if mate[lane] else 0
                    m_end = split if paired and not mate[lane] else length
                    if p >= m_start and p + k <= m_end and p + k <= L and _all_invalid(bits, p, k):
                        ng |= 1 << lane
            st = 0
            for lane in range(32):
                if not ng >> lane & 1:
                    continue
                below = ng & ((1 << lane) - 1)
                if below:
                    src = below.bit_length() - 1
                    is_start = (v[src], mate[src]) != (v[lane], mate[lane])
                else:
                    is_start = last != (v[lane], mate[lane])
                st |= int(is_start) << lane
            for lane in range(32):
                if st >> lane & 1:
                    below_me = (1 << lane) - 1
                    i = runs + _popc(st & below_me)
                    if i <= cap:
                        start[i] = nongaps + _popc(ng & below_me)
                    if i < cap:
                        value[i] = (((v[lane] + 2) << 1) | mate[lane]) & 0xFFFFFFFF
            runs += _popc(st)
            nongaps += _popc(ng)
            mate2 += _popc(ng & sum(m << lane for lane, m in enumerate(mate)))
            if ng:
                hi = ng.bit_length() - 1
                last = (v[hi], mate[hi])
        counts = [((start[j + 1] if j + 1 < runs else nongaps) - start[j]) if j < runs else 0 for j in range(cap)]
        out[r, :cap] = [value[j] if j < runs else _INT_MIN & 0xFFFFFFFF for j in range(cap)]
        out[r, cap : cap + cap // 2] = [counts[2 * j] | (counts[2 * j + 1] << 16) for j in range(cap // 2)]
        out[r, -3:] = runs, nongaps - mate2, mate2
    return out.astype(np.uint32).view(np.int32)
