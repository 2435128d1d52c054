// Fused minimizer scans: narrow minimizers (m <= 31) in XOR order or through
// a rank table, and wide minimizers (31 < m <= 63, at the end of this file).
//
// Replaces the Pallas kernel `_scan_kernel` / `window_minimizers_pallas`
// (slacken_tpu/ops/pallas_kernels.py:26,42), which runs the doubling scans of
// `window_minimizers_impl` (slacken_tpu/ops/minimizers.py:367) on the TPU's
// vector unit. Outputs are those of the plain twin
// `slacken_tpu_torch.ops.minimizers.window_minimizers`, bit for bit. Both
// write -1 as the minimizer of an invalid window (the TPU kernel leaves it
// undefined): no key is negative, so the probe kernel dismisses such a query
// without touching memory.
//
// Design. The 2-bit wire format (encode.pack_2bit: base i at bits 2i of a
// little-endian stream) already is the m-mer: the 2m bits from bit 2p are the
// reverse complement of the m-mer at p before complementing, and the forward
// m-mer is the same bits with their pairs in reverse order (a bit reversal,
// a swap inside each pair, a shift). A priority therefore costs two funnel
// shifts, one `brev` and a dozen logic operations, not a loop over m bases,
// and a window's validity is one k-bit slice of the validity stream compared
// with all ones. One warp owns a row and walks it in chunks of 128 window
// positions, four consecutive positions a lane, four rows a block; nothing
// is shared between warps, so there is no shared memory and no block-wide
// barrier. A lane cuts its 4 + m - 1 bases from three aligned 32-bit loads.
// The minimum over the W = k - m + 1 priorities of a window reaches into the
// next lanes, and past lane 31 into the next chunk: the warp computes the
// priorities of chunk c + 1 before it emits chunk c, so every priority is
// computed once and a shuffle picks the neighbour's value from either chunk.
// `span_start` takes the window before from the lane below; `distinct`
// needs the minimizer of the last valid window before each position,
// possibly many chunks back: a ballot of the lanes that hold a valid window
// names the lane to ask, and the carry across chunks stays in registers.
// A lane stores its four minimizers as two 16-byte words and each flag array
// as one 4-byte word, so a warp writes 1,024 and 3 x 128 contiguous bytes.
//
// Kraken 2's default k = 35, m = 31 gets an instance of its own, in which the
// window's shape and every mask are constants; any other k and m run the
// same code with them read from the arguments.
//
// Explicit orderings (ops/ordering.py, m <= 15) get a third instance: after
// the canonical choice and the spaced mask, the priority is one `__ldg` of a
// rank table of 4^m int32 entries in place of the XOR. Minima, validity,
// `span_start` and `distinct` are the same code. The table is 64 MiB at
// m = 12, 256 MiB at m = 13 and 4 GiB at m = 15, beyond the 50 MB L2 from
// m = 12 on: this instance is then bound by scattered 4-byte loads, one
// 32-byte sector a window position, not by the 11 bytes it writes.
//
// Bound: device-memory bytes written, 11 a position (an int64 minimizer and
// three flag bytes) against 3/8 byte read. What limits the kernel on an H100
// is instruction throughput: about 125 integer instructions and 6 shuffles a
// position in the default instance, half of them the 64-bit compares and
// selects of the minima and of the canonical choice. It reaches 51% of the
// byte bound on 128-wide rows, 45% on 264-wide and 62% on 4,096-wide ones
// (PERF.md, Findings).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int WARPS = 4;   // rows per block (2 to 16 time alike on an H100)
constexpr int CH = 128;    // window positions per warp and chunk, four a lane
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ u64 min64(u64 a, u64 b) { return a < b ? a : b; }

// A row's bytes seen as aligned 32-bit words. Rows start at any byte, so the
// first word may begin up to 3 bytes before the row (`skew`), and a word that
// straddles the row's start or end stays inside its aligned 4 bytes: no load
// leaves the tensor's allocation.
struct Words {
  const uint32_t* base;  // the aligned word that holds the row's first byte
  int skew;              // bytes of that word before the row
  int end;               // skew + bytes in the row

  __device__ __forceinline__ Words(const uint8_t* row, int n_bytes) {
    skew = (int)(reinterpret_cast<uintptr_t>(row) & 3);
    base = reinterpret_cast<const uint32_t*>(row - skew);
    end = skew + n_bytes;
  }
  // word i, or 0 at or past the row's end
  __device__ __forceinline__ uint32_t operator[](int i) const {
    return 4 * i < end ? __ldg(base + i) : 0u;
  }
};

// Priorities of the four m-mers at positions p0 .. p0 + 3 (p0 % 4 == 0) of
// the row whose packed bytes are `row`. Bits past the row's end are 0.
// With a rank table `lut` the priority is the rank of the masked canonical
// m-mer (2m <= 30 bits, always inside the table) and `toggle` is unused.
template <bool LUT>
__device__ __forceinline__ void priorities(const Words& row, int p0, int m, int canonical,
                                           u64 toggle, u64 smask, const int* __restrict__ lut,
                                           u64 (&q)[4]) {
  const int at = row.skew + (p0 >> 2), i = at >> 2;
  const unsigned sh = 8 * (at & 3);
  const uint32_t w0 = row[i], w1 = row[i + 1], w2 = row[i + 2];
  // 72 bits of the stream from base p0: 4 + 31 - 1 bases are 68 bits
  const uint32_t s0 = __funnelshift_r(w0, w1, sh);
  const uint32_t s1 = __funnelshift_r(w1, w2, sh);
  const uint32_t s2 = w2 >> sh;
  const u64 mask = (1ull << (2 * m)) - 1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const u64 s =
        (((u64)__funnelshift_r(s1, s2, 2 * j) << 32) | __funnelshift_r(s0, s1, 2 * j)) & mask;
    u64 r = __brevll(s);  // pair t lands at pair 31 - t with its two bits swapped
    r = ((r >> 1) & 0x5555555555555555ull) | ((r & 0x5555555555555555ull) << 1);
    const u64 fwd = r >> (64 - 2 * m);
    const u64 rc = ~s & mask;
    const u64 v = (canonical && rc < fwd) ? rc : fwd;
    if constexpr (LUT) {
      q[j] = (u64)__ldg(lut + (v & smask));
    } else {
      q[j] = (v ^ toggle) & smask;
    }
  }
}

// 64 validity bits of the row from position p; positions at or past L read 0.
__device__ __forceinline__ u64 valid64(const Words& row, int L, int p) {
  if (p >= L) return 0;
  const int at = row.skew + (p >> 3), i = at >> 2;
  const unsigned sh = 8 * (at & 3) + (p & 7);  // at most 31
  const uint32_t w0 = row[i], w1 = row[i + 1], w2 = row[i + 2];
  u64 v = ((u64)__funnelshift_r(w1, w2, sh) << 32) | __funnelshift_r(w0, w1, sh);
  if (L - p < 64) v &= (1ull << (L - p)) - 1;  // the next row's bits
  return v;
}

// The value that the lane `d` lanes ahead holds (1 <= d <= 31): `e` while
// that lane is in this chunk, `n`, the next chunk's, past lane 31.
__device__ __forceinline__ u64 ahead(u64 e, u64 n, int d, int lane) {
  return __shfl_sync(FULL, lane >= d ? e : n, (lane + d) & 31);
}

__device__ __forceinline__ u64 pick(const u64 (&a)[4], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// One byte of 0 or 1 for each of the four low bits.
__device__ __forceinline__ uint32_t spread4(unsigned bits) {
  return (bits * 0x00204081u) & 0x01010101u;
}

// K, M: k and m when the compiler should know them (the window's shape and
// every mask fold to constants), 0 to read them from the arguments. LUT: the
// priority is a rank read from `lut`.
template <int K, int M, bool LUT>
__global__ void __launch_bounds__(32 * WARPS)
scan_kernel(const uint8_t* __restrict__ packed, const uint8_t* __restrict__ vbits, long long B,
            int L, int k_arg, int m_arg, int canonical, u64 toggle, u64 smask,
            const int* __restrict__ lut, long long* __restrict__ out_min, uint8_t* __restrict__ out_valid,
            uint8_t* __restrict__ out_start, uint8_t* __restrict__ out_distinct) {
  const int k = K ? K : k_arg, m = M ? M : m_arg;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;  // the lanes below this one
  const int W = k - m + 1;
  // a window's last priority is W - 1 ahead of its first: D0 whole lanes and e0 more
  const int D0 = (W - 1) >> 2, e0 = (W - 1) & 3;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= B) return;  // the whole warp
  const Words rp(packed + row * (L / 4), L / 4);
  const Words rv(vbits + row * (L / 8), L / 8);

  // carries across chunks, equal in every lane
  int c_prev_valid = 0, c_has_last = 0;
  u64 c_prev_min = 0, c_last_min = 0;

  u64 qn[4];
  priorities<LUT>(rp, 4 * lane, m, canonical, toggle, smask, lut, qn);
  for (int cs = 0; cs < L; cs += CH) {
    const int p0 = cs + 4 * lane;
    const bool more = cs + CH < L;
    u64 q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) q[j] = qn[j];
    if (more) {
      priorities<LUT>(rp, p0 + CH, m, canonical, toggle, smask, lut, qn);
    } else {  // only windows that run past the row's end look there
#pragma unroll
      for (int j = 0; j < 4; ++j) qn[j] = 0;
    }

    // window minima: the rest of this lane, whole lanes between, the start
    // of the lane where the window ends
    u64 pe[4], pn[4], se[4];
    pe[0] = q[0];
    pn[0] = qn[0];
    se[3] = q[3];
#pragma unroll
    for (int j = 1; j < 4; ++j) {
      pe[j] = min64(pe[j - 1], q[j]);
      pn[j] = min64(pn[j - 1], qn[j]);
      se[3 - j] = min64(se[4 - j], q[3 - j]);
    }
    u64 between = ~0ull;  // lanes 1 .. D0 - 1 ahead
    for (int d = 1; d < D0; ++d) between = min64(between, ahead(pe[3], pn[3], d, lane));
    u64 between1 = between;  // and lane D0 ahead, for windows that end in lane D0 + 1
    if (D0 >= 1 && e0 > 0) between1 = min64(between, ahead(pe[3], pn[3], D0, lane));
    u64 mn[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int last = e0 + j;  // index of the window's last priority in lane D0 ahead
      if (last < 4 && D0 == 0) {  // the window lies inside this lane
        u64 r = q[j];
#pragma unroll
        for (int t = j + 1; t < 4; ++t)
          if (t <= last) r = min64(r, q[t]);
        mn[j] = r;
      } else if (last < 4) {
        u64 r = min64(se[j], ahead(pick(pe, last), pick(pn, last), D0, lane));
        if (D0 > 1) r = min64(r, between);
        mn[j] = r;
      } else {
        u64 r = min64(se[j], ahead(pick(pe, last - 4), pick(pn, last - 4), D0 + 1, lane));
        if (D0 >= 1) r = min64(r, between1);
        mn[j] = r;
      }
    }

    // window validity: bits [j, j + k) of the validity stream from p0 all set
    unsigned ok = 0xfu;
    if (k <= 61) {
      const u64 inv = ~valid64(rv, L, p0);
      const u64 ones = (1ull << k) - 1;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if ((inv >> j) & ones) ok &= ~(1u << j);
    } else {
      for (int base = 0; base < k + 3; base += 64) {
        const u64 inv = ~valid64(rv, L, p0 + base);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int lo = max(j, base) - base, hi = min(j + k, base + 64) - base;
          if (hi > lo) {
            const u64 bits = (hi - lo == 64 ? ~0ull : (1ull << (hi - lo)) - 1) << lo;
            if (inv & bits) ok &= ~(1u << j);
          }
        }
      }
    }

    // span_start: against the window before (lane below, or the chunk before)
    int prev_valid = __shfl_up_sync(FULL, (int)(ok >> 3), 1);
    u64 prev_min = __shfl_up_sync(FULL, mn[3], 1);
    if (lane == 0) {
      prev_valid = c_prev_valid;
      prev_min = c_prev_min;
    }
    unsigned start = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = (ok >> j) & 1;
      if (v && (!prev_valid || mn[j] != prev_min)) start |= 1u << j;
      prev_valid = v;
      prev_min = mn[j];
    }

    // distinct: against the last valid window before, which the highest
    // lane below that holds a valid window knows
    const u64 lane_last = pick(mn, ok ? 31 - __clz((int)ok) : 0);  // this lane's last valid
    const unsigned holders = __ballot_sync(FULL, ok != 0);
    const int before = 31 - __clz((int)(holders & below));  // -1: none in this chunk
    u64 before_min = __shfl_sync(FULL, lane_last, before & 31);
    int has = 1;
    if (before < 0) {
      has = c_has_last;
      before_min = c_last_min;
    }
    unsigned distinct = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (((start >> j) & 1) && (!has || mn[j] != before_min)) distinct |= 1u << j;
      if ((ok >> j) & 1) {
        has = 1;
        before_min = mn[j];
      }
    }

    if (p0 < L) {  // L % 8 == 0: all four positions, 16- and 4-byte aligned
      const long long o = row * L + p0;
      longlong2* om = reinterpret_cast<longlong2*>(out_min + o);
      om[0] = make_longlong2(ok & 1 ? (long long)mn[0] : -1, ok & 2 ? (long long)mn[1] : -1);
      om[1] = make_longlong2(ok & 4 ? (long long)mn[2] : -1, ok & 8 ? (long long)mn[3] : -1);
      *reinterpret_cast<uint32_t*>(out_valid + o) = spread4(ok);
      *reinterpret_cast<uint32_t*>(out_start + o) = spread4(start);
      *reinterpret_cast<uint32_t*>(out_distinct + o) = spread4(distinct);
    }

    if (more) {
      c_prev_valid = __shfl_sync(FULL, (int)(ok >> 3), 31);
      c_prev_min = __shfl_sync(FULL, mn[3], 31);
      const u64 last_min = __shfl_sync(FULL, lane_last, (31 - __clz((int)holders)) & 31);
      if (holders) {
        c_has_last = 1;
        c_last_min = last_min;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Wide minimizers (31 < m <= 63)
// ---------------------------------------------------------------------------
//
// Computes what `window_minimizers_impl` (slacken_tpu/ops/minimizers.py:367)
// computes on its wide branch (priorities_at_starts_wide :266,
// sliding_min_u128 :285, there over four 32-bit limbs), bit for bit the plain
// twin `slacken_tpu_torch.ops.minimizers.window_minimizers` for a wide m.
//
// Design. A priority is a 2m-bit value in two 64-bit limbs (hi below 2^62, lo
// unsigned). As in the narrow kernel the wire format is the m-mer: the 2m
// bits from bit 2p, cut from five aligned 32-bit loads, are the reverse
// complement before complementing, and the forward m-mer is the same 128
// bits with their pairs in reverse order. One warp owns a row and walks it
// in chunks of 32 window positions, one a lane. Each priority is computed
// once and kept in a ring of 256 entries in shared memory, one ring a warp:
// the warp writes the priorities of the chunk `ahead` positions further on,
// then every lane takes the minimum over the W = k - m + 1 entries of its
// window. That loop is O(W) a position: simple, and cheap at the small
// windows wide minimizers are used with (W = 3 to 18 here). `span_start`
// and `distinct` follow the narrow kernel: the window before from the lane
// below, the last valid window from a ballot, carries in registers. A lane
// stores its minimizer as one 16-byte word (hi, lo).
//
// Limit: k - m <= 120 (the ring holds 32 + 128 priorities of lookahead).
//
// Bound: device-memory bytes written, 19 a position (two int64 limbs and
// three flag bytes) against 3/8 byte read.

struct K2 {
  u64 hi, lo;
};

__device__ __forceinline__ bool less2(const K2& a, const K2& b) {
  return a.hi < b.hi || (a.hi == b.hi && a.lo < b.lo);
}

__device__ __forceinline__ bool differ2(const K2& a, const K2& b) {
  return a.hi != b.hi || a.lo != b.lo;
}

// the 32 bit pairs of a 64-bit word in reverse order
__device__ __forceinline__ u64 reverse_pairs(u64 s) {
  const u64 r = __brevll(s);
  return ((r >> 1) & 0x5555555555555555ull) | ((r & 0x5555555555555555ull) << 1);
}

// Priority of the m-mer at position p (32 <= m <= 63). Bits past the row's
// end are 0.
__device__ __forceinline__ K2 priority_wide(const Words& row, int p, int m, int canonical,
                                            K2 toggle, K2 smask) {
  const int at = row.skew + (p >> 2), i = at >> 2;
  const unsigned sh = 8 * (at & 3) + 2 * (p & 3);  // at most 30
  const uint32_t w0 = row[i], w1 = row[i + 1], w2 = row[i + 2], w3 = row[i + 3], w4 = row[i + 4];
  // 128 bits of the stream from base p, cut to the m-mer's 2m
  const u64 hi_mask = m == 32 ? 0ull : (1ull << (2 * m - 64)) - 1;
  const u64 s_lo = ((u64)__funnelshift_r(w1, w2, sh) << 32) | __funnelshift_r(w0, w1, sh);
  const u64 s_hi = (((u64)__funnelshift_r(w3, w4, sh) << 32) | __funnelshift_r(w2, w3, sh)) & hi_mask;
  // forward: all 64 pairs reversed (the limbs change places), right-aligned
  const u64 r_hi = reverse_pairs(s_lo), r_lo = reverse_pairs(s_hi);
  const int t = 128 - 2 * m;  // 2 .. 64
  K2 v;
  v.hi = t == 64 ? 0ull : r_hi >> t;
  v.lo = t == 64 ? r_hi : (r_lo >> t) | (r_hi << (64 - t));
  const K2 rc = {~s_hi & hi_mask, ~s_lo};
  if (canonical && less2(rc, v)) v = rc;
  v.hi = (v.hi ^ toggle.hi) & smask.hi;
  v.lo = (v.lo ^ toggle.lo) & smask.lo;
  return v;
}

constexpr int RING = 256;  // priorities a warp keeps: a chunk and up to 128 of lookahead

__global__ void __launch_bounds__(32 * WARPS)
scan_wide_kernel(const uint8_t* __restrict__ packed, const uint8_t* __restrict__ vbits,
                 long long B, int L, int k, int m, int canonical, K2 toggle, K2 smask,
                 ulonglong2* __restrict__ out_min, uint8_t* __restrict__ out_valid,
                 uint8_t* __restrict__ out_start, uint8_t* __restrict__ out_distinct) {
  __shared__ ulonglong2 rings[WARPS][RING];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1;
  const int W = k - m + 1;
  const int ahead_by = (W + 30) & ~31;  // W - 1 rounded up to whole chunks
  const long long row = (long long)blockIdx.x * WARPS + warp;
  if (row >= B) return;  // the whole warp
  const Words rp(packed + row * (L / 4), L / 4);
  const Words rv(vbits + row * (L / 8), L / 8);
  ulonglong2* ring = rings[warp];

  for (int c = 0; c < ahead_by; c += 32) {
    const K2 q = priority_wide(rp, c + lane, m, canonical, toggle, smask);
    ring[(c + lane) & (RING - 1)] = make_ulonglong2(q.hi, q.lo);
  }

  // carries across chunks, equal in every lane
  int c_prev_valid = 0, c_has_last = 0;
  K2 c_prev_min = {0, 0}, c_last_min = {0, 0};

  for (int cs = 0; cs < L; cs += 32) {
    const int p = cs + lane;
    {
      // positions past the row's end give priorities of zero bits, which
      // only windows that are invalid anyway look at
      const K2 q = priority_wide(rp, p + ahead_by, m, canonical, toggle, smask);
      ring[(p + ahead_by) & (RING - 1)] = make_ulonglong2(q.hi, q.lo);
    }
    __syncwarp();
    K2 mn = {~0ull, ~0ull};
    for (int t = 0; t < W; ++t) {
      const ulonglong2 e = ring[(p + t) & (RING - 1)];
      const K2 q = {e.x, e.y};
      if (less2(q, mn)) mn = q;
    }

    // window validity: the k validity bits from p all set
    int ok = p < L;
    for (int base = 0; base < k && ok; base += 64) {
      const int nbits = min(64, k - base);
      const u64 want = nbits == 64 ? ~0ull : (1ull << nbits) - 1;
      if (~valid64(rv, L, p + base) & want) ok = 0;
    }

    // span_start: against the window before (lane below, or the chunk before)
    int prev_valid = __shfl_up_sync(FULL, ok, 1);
    K2 prev_min = {__shfl_up_sync(FULL, mn.hi, 1), __shfl_up_sync(FULL, mn.lo, 1)};
    if (lane == 0) {
      prev_valid = c_prev_valid;
      prev_min = c_prev_min;
    }
    const int start = ok && (!prev_valid || differ2(mn, prev_min));

    // distinct: against the last valid window before, which the highest
    // lane below that holds a valid window knows
    const unsigned holders = __ballot_sync(FULL, ok);
    const int before = 31 - __clz((int)(holders & below));  // -1: none in this chunk
    K2 before_min = {__shfl_sync(FULL, mn.hi, before & 31), __shfl_sync(FULL, mn.lo, before & 31)};
    int has = 1;
    if (before < 0) {
      has = c_has_last;
      before_min = c_last_min;
    }
    const int distinct = start && (!has || differ2(mn, before_min));

    if (p < L) {
      const long long o = row * L + p;
      out_min[o] = ok ? make_ulonglong2(mn.hi, mn.lo) : make_ulonglong2(~0ull, ~0ull);
      out_valid[o] = (uint8_t)ok;
      out_start[o] = (uint8_t)start;
      out_distinct[o] = (uint8_t)distinct;
    }

    c_prev_valid = __shfl_sync(FULL, ok, 31);
    c_prev_min.hi = __shfl_sync(FULL, mn.hi, 31);
    c_prev_min.lo = __shfl_sync(FULL, mn.lo, 31);
    const int last_holder = (31 - __clz((int)holders)) & 31;
    const K2 last_min = {__shfl_sync(FULL, mn.hi, last_holder), __shfl_sync(FULL, mn.lo, last_holder)};
    if (holders) {
      c_has_last = 1;
      c_last_min = last_min;
    }
  }
}

}  // namespace

// packed: [B, L/4] u8, vbits: [B, L/8] u8 (encode.pack_2bit layout); L % 8 == 0,
// 1 <= m <= 31, m <= k <= m + 120. lut: null for the XOR order, else a rank
// table of 4^m int32 (m <= 15; toggle is then unused). Outputs [B, L]: int64
// minimizer (16-byte aligned), u8 valid / span_start / distinct (4-byte aligned).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int stpu_scan(const void* packed, const void* vbits, long long B, int L,
                         int k, int m, int canonical, unsigned long long toggle,
                         unsigned long long smask, const void* lut, void* out_min,
                         void* out_valid, void* out_start, void* out_distinct, void* stream) {
  if (B <= 0) return 0;
  const long long blocks = (B + WARPS - 1) / WARPS;
  // Kraken 2's default k and m get their own instance, a rank table another
  auto kernel = lut ? scan_kernel<0, 0, true>
                    : (k == 35 && m == 31) ? scan_kernel<35, 31, false> : scan_kernel<0, 0, false>;
  kernel<<<(unsigned)blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const uint8_t*)vbits, B, L, k, m, canonical, toggle, smask,
      (const int*)lut, (long long*)out_min, (uint8_t*)out_valid, (uint8_t*)out_start, (uint8_t*)out_distinct);
  return (int)cudaGetLastError();
}

// The wide scan: 32 <= m <= 63, m <= k <= m + 120; toggle and smask are the
// (hi64, lo64) limbs of the 2m-bit masks. out_min: [B, L, 2] int64 (hi64,
// lo64), 16-byte aligned; the flags as above, any alignment.
extern "C" int stpu_scan_wide(const void* packed, const void* vbits, long long B, int L,
                              int k, int m, int canonical, unsigned long long toggle_hi,
                              unsigned long long toggle_lo, unsigned long long smask_hi,
                              unsigned long long smask_lo, void* out_min, void* out_valid,
                              void* out_start, void* out_distinct, void* stream) {
  if (B <= 0) return 0;
  const long long blocks = (B + WARPS - 1) / WARPS;
  scan_wide_kernel<<<(unsigned)blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const uint8_t*)vbits, B, L, k, m, canonical,
      K2{toggle_hi, toggle_lo}, K2{smask_hi, smask_lo}, (ulonglong2*)out_min,
      (uint8_t*)out_valid, (uint8_t*)out_start, (uint8_t*)out_distinct);
  return (int)cudaGetLastError();
}
