// Fused minimizer scans: narrow minimizers (m <= 31) in XOR order or through
// a rank table, and wide minimizers (31 < m <= 63), one kernel template; a
// long row cut into segments is stitched inside the same launch.
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
// with all ones. One warp owns a row (or a segment of one, below) and walks
// it in chunks of 128 window positions, four consecutive positions a lane,
// four warps a block; nothing is shared between warps, so there is no shared
// memory and no block-wide barrier. A lane cuts its 4 + m - 1 bases from
// three aligned 32-bit loads (five for a wide m). The minimum over the
// W = k - m + 1 priorities of a window is the rest of the lane (an in-lane
// suffix minimum), whole lanes between (their full minima, by shuffles) and
// the start of the lane where the window ends (an in-lane prefix minimum);
// past lane 31 it reaches into the next chunk: the warp computes the
// priorities of chunk c + 1 before it emits chunk c, so every priority is
// computed once and a shuffle picks the neighbour's value from either chunk.
// `span_start` takes the window before from the lane below; `distinct`
// needs the minimizer of the last valid window before each position,
// possibly many chunks back: a ballot of the lanes that hold a valid window
// names the lane to ask, and the carry across chunks stays in registers.
// A lane stores its four minimizers as two 16-byte words (four for a wide m)
// and each flag array as one 4-byte word, so a warp writes 1,024 (2,048) and
// 3 x 128 contiguous bytes.
//
// Kraken 2's default k = 35, m = 31 gets an instance of its own, in which the
// window's shape and every mask are constants; any other k and m run the
// same code with them read from the arguments.
//
// Explicit orderings (ops/ordering.py, m <= 15) get a third instance: after
// the canonical choice and the spaced mask, the priority is one `__ldg` of a
// rank table of 4^m int32 entries in place of the XOR. The table is 64 MiB at
// m = 12, 256 MiB at m = 13 and 4 GiB at m = 15, beyond the 50 MB L2 from
// m = 12 on: this instance is then bound by scattered 4-byte loads, one
// 32-byte sector from device memory a window position for the share of the
// table that the L2 cannot hold, not by the 11 bytes it writes.
//
// Wide minimizers (31 < m <= 63) replace the wide branch of
// `window_minimizers_impl` (slacken_tpu/ops/minimizers.py:372-379:
// priorities_at_starts_wide :266, sliding_min_u128 :285, there over four
// 32-bit limbs), which XLA compiled. A priority is a 2m-bit value in two
// 64-bit limbs (hi below 2^62, lo unsigned), compared as one unsigned 128-bit
// value; the code is the narrow one on such pairs. A lane reverses the pairs
// of its 160 bits of stream once and cuts the four forward m-mers from that
// by funnel shifts. A pair moves between lanes in four 32-bit shuffles.
// Every k and m share one instance. Pairs are chosen limb by limb
// (`choose`): a conditional between two pairs selects an address, and puts
// the arrays that hold them in local memory.
// Limit: k - m <= 120, as for the narrow scan.
//
// Long rows. One warp a row leaves the card idle when rows are few and long:
// bracken's batch of four 2^20-wide fragment rows would be one block on one
// SM of 132. The wrapper then cuts every row into segments of S positions
// (a multiple of the chunk; the row's last segment may be shorter), one warp
// a (row, segment). A warp starts one chunk early and discards it: that
// warm-up chunk gives the window before the segment (`span_start`) exactly,
// and the last valid minimizer (`distinct`) whenever the chunk holds a valid
// window. The look-ahead reads the row past the segment's end: only the
// row's end zeroes it. What the warm-up cannot see is a valid window further
// back. Only the segment's first valid window can need it, and only when the
// warm-up holds none; the warp then writes `distinct` = `span_start` = 1
// there. Each warp writes a summary of its segment: whether it holds a valid
// window, the minimizer of its last, and the flat position of that first
// window when it needs the carry. The carry of `_carry_forward`
// (slacken_tpu/ops/minimizers.py:417, called at :397) across segments is
// taken in the same launch: after its summary, every lane fences its stores
// and lane 0 adds one to the row's arrival counter; the warp that arrives
// last (the add returns nseg - 1) fences again and stitches the row
// (`stitch_row`). It reads the row's summaries, a segment a lane and 256 at
// a time, with coherent loads (`__ldcg`: they were written by other SMs in
// this launch), finds each needing segment's nearest earlier segment that
// holds a valid window by a ballot of the lanes below and a carry across
// chunks of 32, clears that first window's `distinct` byte when the two
// minimizers are equal, and sets the counter back to 0. No warp waits on
// another, so block order cannot deadlock it; a row costs one pass over its
// summaries, two trips to the L2 a 256 segments (a stitch that walked a
// chunk of 32 at a time, two dependent trips each, added 0.012 ms at
// bracken's 512 segments a row, PERF.md). The counters are a
// zeroed int32 buffer of at least B entries a (device, stream), kept by the
// wrapper: a memset a launch would spend the launch that this saves. A row
// that is one segment (SEG = false) writes no summary, counts nothing and
// fences nothing.
//
// Bound: device-memory bytes written, 11 a position (an int64 minimizer and
// three flag bytes; 19 for a wide m) against 3/8 byte read. What limits the
// kernel on an H100 is instruction throughput: about 125 integer
// instructions and 6 shuffles a position in the default instance, half of
// them the 64-bit compares and selects of the minima and of the canonical
// choice, and about twice that in the wide one. It reaches 51% of the byte
// bound on 128-wide rows, 45% on 264-wide and 62% on 4,096-wide ones; the
// wide instance 31-47% (PERF.md, Findings).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int WARPS = 4;   // warps per block (2 to 16 time alike on an H100)
constexpr int CH = 128;    // window positions per warp and chunk, four a lane
constexpr unsigned FULL = 0xffffffffu;

// the three orders of priorities: XOR with the toggle mask, a rank table,
// and XOR over two limbs for a wide m
enum Order { XOR = 0, LUT = 1, WIDE = 2 };

// A wide priority: hi64 (below 2^62) over lo64, compared as unsigned limbs.
struct K2 {
  u64 hi, lo;
};

template <int ORDER> struct KeyOf { typedef u64 T; };
template <> struct KeyOf<WIDE> { typedef K2 T; };

__device__ __forceinline__ bool less2(const K2& a, const K2& b) {
  return ((unsigned __int128)a.hi << 64 | a.lo) < ((unsigned __int128)b.hi << 64 | b.lo);
}

__device__ __forceinline__ K2 choose(bool c, K2 a, K2 b) { return {c ? a.hi : b.hi, c ? a.lo : b.lo}; }

__device__ __forceinline__ u64 kmin(u64 a, u64 b) { return a < b ? a : b; }
__device__ __forceinline__ K2 kmin(K2 a, K2 b) { return choose(less2(b, a), b, a); }

__device__ __forceinline__ bool differ(u64 a, u64 b) { return a != b; }
__device__ __forceinline__ bool differ(const K2& a, const K2& b) { return a.hi != b.hi || a.lo != b.lo; }

__device__ __forceinline__ void fill(u64& v, u64 x) { v = x; }
__device__ __forceinline__ void fill(K2& v, u64 x) { v = {x, x}; }

// Shuffles of a narrow priority or a wide pair.
__device__ __forceinline__ u64 shfl(u64 v, int src) { return __shfl_sync(FULL, v, src); }
__device__ __forceinline__ K2 shfl(const K2& v, int src) {
  return {__shfl_sync(FULL, v.hi, src), __shfl_sync(FULL, v.lo, src)};
}

__device__ __forceinline__ u64 shfl_up(u64 v) { return __shfl_up_sync(FULL, v, 1); }
__device__ __forceinline__ K2 shfl_up(const K2& v) {
  return {__shfl_up_sync(FULL, v.hi, 1), __shfl_up_sync(FULL, v.lo, 1)};
}

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
template <bool USE_LUT>
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
    if constexpr (USE_LUT) {
      q[j] = (u64)__ldg(lut + (v & smask));
    } else {
      q[j] = (v ^ toggle) & smask;
    }
  }
}

// Wide priorities (32 <= m <= 63) of the four m-mers at p0 .. p0 + 3
// (p0 % 4 == 0): the 4 + m - 1 <= 66 bases from p0 lie in five aligned words
// (at most 24 bits of skew + 132 bits), and the 128 bits from base p0 + j are
// four funnel shifts of them by 8 * skew + 2j <= 30 bits. Bits past the
// row's end are 0.
__device__ __forceinline__ void priorities_wide(const Words& row, int p0, int m, int canonical,
                                                const K2& toggle, const K2& smask, K2 (&q)[4]) {
  const int at = row.skew + (p0 >> 2), i = at >> 2;
  const unsigned sh = 8 * (at & 3);
  const uint32_t w0 = row[i], w1 = row[i + 1], w2 = row[i + 2], w3 = row[i + 3], w4 = row[i + 4];
  const u64 hi_mask = m == 32 ? 0ull : (1ull << (2 * m - 64)) - 1;
  // the 160 bits from base p0 with their 80 pairs in reverse order, R, once a
  // lane; the forward m-mer at p0 + j is R >> 2 (80 - m - j), cut to 2m bits:
  // here F = R >> 2 (77 - m) (6 + 2m bits), and then F >> 2 (3 - j)
  const uint32_t x[5] = {__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                         __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh), w4 >> sh};
  uint32_t r[7];
#pragma unroll
  for (int t = 0; t < 5; ++t) {
    const uint32_t b = __brev(x[4 - t]);
    r[t] = ((b >> 1) & 0x55555555u) | ((b & 0x55555555u) << 1);
  }
  r[5] = r[6] = 0;
  const int cut = 2 * (77 - m), wq = cut >> 5;  // 28 .. 90 bits: word 0, 1 or 2
  uint32_t f[5];
#pragma unroll
  for (int t = 0; t < 5; ++t) {
    const uint32_t a = wq == 0 ? r[t] : wq == 1 ? r[t + 1] : r[t + 2];
    const uint32_t b = wq == 0 ? r[t + 1] : wq == 1 ? r[t + 2] : (t + 3 < 7 ? r[t + 3] : 0u);
    f[t] = __funnelshift_r(a, b, cut & 31);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned s = sh + 2 * j;
    // 128 bits of the stream from base p0 + j, cut to the m-mer's 2m
    const u64 s_lo = ((u64)__funnelshift_r(w1, w2, s) << 32) | __funnelshift_r(w0, w1, s);
    const u64 s_hi = (((u64)__funnelshift_r(w3, w4, s) << 32) | __funnelshift_r(w2, w3, s)) & hi_mask;
    K2 v;
    const unsigned u = 2 * (3 - j);
    v.lo = ((u64)__funnelshift_r(f[1], f[2], u) << 32) | __funnelshift_r(f[0], f[1], u);
    v.hi = (((u64)__funnelshift_r(f[3], f[4], u) << 32) | __funnelshift_r(f[2], f[3], u)) & hi_mask;
    const K2 rc = {~s_hi & hi_mask, ~s_lo};
    v = choose(canonical && less2(rc, v), rc, v);
    q[j].hi = (v.hi ^ toggle.hi) & smask.hi;
    q[j].lo = (v.lo ^ toggle.lo) & smask.lo;
  }
}

template <int ORDER>
__device__ __forceinline__ void priorities4(const Words& row, int p0, int m, int canonical,
                                            const typename KeyOf<ORDER>::T& toggle,
                                            const typename KeyOf<ORDER>::T& smask,
                                            const int* __restrict__ lut,
                                            typename KeyOf<ORDER>::T (&q)[4]) {
  if constexpr (ORDER == WIDE) {
    priorities_wide(row, p0, m, canonical, toggle, smask, q);
  } else {
    priorities<ORDER == LUT>(row, p0, m, canonical, toggle, smask, lut, q);
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
  return shfl(lane >= d ? e : n, (lane + d) & 31);
}
__device__ __forceinline__ K2 ahead(K2 e, K2 n, int d, int lane) {
  return shfl(choose(lane >= d, e, n), (lane + d) & 31);
}

__device__ __forceinline__ u64 pick(const u64 (&a)[4], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}
__device__ __forceinline__ K2 pick(const K2 (&a)[4], int i) {
  return choose(i == 0, a[0], choose(i == 1, a[1], choose(i == 2, a[2], a[3])));
}

// One byte of 0 or 1 for each of the four low bits.
__device__ __forceinline__ uint32_t spread4(unsigned bits) {
  return (bits * 0x00204081u) & 0x01010101u;
}

// The carry across the segments of one row, by the warp that finished the
// row's last segment (see "Long rows"). summary: the row's nseg summaries;
// out_min: the whole [B, L] or [B, L, 2] minimizer array, which the flat
// positions index; LIMBS: 1 (narrow, compared with the summary's lo64) or 2.
// Lane j of a chunk takes segment c + j: the nearest earlier segment that
// holds a valid window is the highest holder among the lanes below, else the
// carry from the chunks before. G chunks at a time, so that the walk of a
// row costs two trips to the L2 a G chunks (the summaries, then the
// minimizers to compare), not two a chunk.
template <int LIMBS>
__device__ __forceinline__ void stitch_row(const long long* summary, int nseg, const long long* out_min,
                                           uint8_t* out_distinct, int lane) {
  constexpr int G = 8;
  const unsigned below = (1u << lane) - 1;
  int carry = -1;  // the last segment of the chunks before that holds a valid window
  for (int c0 = 0; c0 < nseg; c0 += 32 * G) {
    long long first[G];  // the flat position of each segment's first window that needs the carry, or -1
    unsigned has = 0;    // bit g: segment c0 + 32 g + lane holds a valid window
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int j = c0 + 32 * g + lane;
      const longlong2 v = j < nseg ? __ldcg(reinterpret_cast<const longlong2*>(summary + 4 * j))
                                   : make_longlong2(0, -1);
      has |= (unsigned)(v.x != 0) << g;
      first[g] = v.y;
    }
    int before[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const unsigned holders = __ballot_sync(FULL, (has >> g) & 1);
      const unsigned lower = holders & below;
      before[g] = lower ? c0 + 32 * g + 31 - __clz((int)lower) : carry;
      if (holders) carry = c0 + 32 * g + 31 - __clz((int)holders);
    }
    unsigned same = 0;  // loads first, stores after: a byte store may alias them
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (first[g] >= 0 && before[g] >= 0) {
        const long long* last = summary + 4 * before[g] + 2;  // (hi64, lo64)
        bool eq;
        if constexpr (LIMBS == 2) {
          const longlong2 a = __ldcg(reinterpret_cast<const longlong2*>(out_min) + first[g]);
          const longlong2 b = __ldcg(reinterpret_cast<const longlong2*>(last));
          eq = a.x == b.x && a.y == b.y;
        } else {
          eq = __ldcg(out_min + first[g]) == __ldcg(last + 1);
        }
        same |= (unsigned)eq << g;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
      if ((same >> g) & 1) out_distinct[first[g]] = 0;
  }
}

// K, M: k and m when the compiler should know them (the window's shape and
// every mask fold to constants), 0 to read them from the arguments. ORDER:
// XOR (u64 priorities, minimizers int64 [B, L]), LUT (a rank read from
// `lut`) or WIDE (K2 priorities, minimizers (hi64, lo64) [B, L, 2]). SEG:
// rows in segments: warp w scans segment w % nseg of row w / nseg,
// positions [s0, s1) with s0 = S * segment, writes its summary (int64
// [B * nseg, 4]) and counts itself in counters[row]; the row's last warp
// stitches it. Without SEG, warp w scans row w and nothing else changes.
template <int K, int M, int ORDER, bool SEG>
__device__ __forceinline__ void
scan_rows(const uint8_t* __restrict__ packed, const uint8_t* __restrict__ vbits, long long B,
          int L, int S, int nseg, int k_arg, int m_arg, int canonical,
          typename KeyOf<ORDER>::T toggle, typename KeyOf<ORDER>::T smask,
          const int* __restrict__ lut, void* __restrict__ out_min, uint8_t* __restrict__ out_valid,
          uint8_t* __restrict__ out_start, uint8_t* __restrict__ out_distinct,
          long long* __restrict__ summary, int* __restrict__ counters) {
  typedef typename KeyOf<ORDER>::T Key;
  const int k = K ? K : k_arg, m = M ? M : m_arg;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;  // the lanes below this one
  const int W = k - m + 1;
  // a window's last priority is W - 1 ahead of its first: D0 whole lanes and e0 more
  const int D0 = (W - 1) >> 2, e0 = (W - 1) & 3;
  const long long warp = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  long long row = warp;
  int seg = 0, s0 = 0, s1 = L;
  if constexpr (SEG) {
    if (warp >= B * nseg) return;  // the whole warp; B * nseg < 2^31 (launch)
    row = (unsigned)warp / (unsigned)nseg;
    seg = (int)(warp - row * nseg);
    s0 = seg * S;
    s1 = min(L, s0 + S);
  } else if (row >= B) {
    return;  // the whole warp
  }
  const Words rp(packed + row * (L / 4), L / 4);
  const Words rv(vbits + row * (L / 8), L / 8);

  // carries across chunks, equal in every lane
  int c_prev_valid = 0, c_has_last = 0;
  Key c_prev_min{}, c_last_min{};
  // the segment's summary: a valid window in [s0, s1); the flat position of
  // its first when nothing before it in the warp's reach is valid
  int seg_has = 0;
  long long first = -1;

  // every segment but a row's first starts with a warm-up chunk
  const int begin = seg ? s0 - CH : 0;
  Key qn[4];
  priorities4<ORDER>(rp, begin + 4 * lane, m, canonical, toggle, smask, lut, qn);
  for (int cs = begin; cs < s1; cs += CH) {
    const int p0 = cs + 4 * lane;
    const bool more = cs + CH < L;
    Key q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) q[j] = qn[j];
    if (more) {  // the row past the segment's end too: windows near it look there
      priorities4<ORDER>(rp, p0 + CH, m, canonical, toggle, smask, lut, qn);
    } else {  // only windows that run past the row's end look there
#pragma unroll
      for (int j = 0; j < 4; ++j) fill(qn[j], 0);
    }

    // window minima: the rest of this lane, whole lanes between, the start
    // of the lane where the window ends
    Key pe[4], pn[4], se[4];
    pe[0] = q[0];
    pn[0] = qn[0];
    se[3] = q[3];
#pragma unroll
    for (int j = 1; j < 4; ++j) {
      pe[j] = kmin(pe[j - 1], q[j]);
      pn[j] = kmin(pn[j - 1], qn[j]);
      se[3 - j] = kmin(se[4 - j], q[3 - j]);
    }
    Key between;  // lanes 1 .. D0 - 1 ahead
    fill(between, ~0ull);
    for (int d = 1; d < D0; ++d) between = kmin(between, ahead(pe[3], pn[3], d, lane));
    // all of lane D0 ahead: for the window that ends at its last position, and
    // (with the lanes between) for those that end in lane D0 + 1
    Key whole_d0 = between;
    if (D0 >= 1) whole_d0 = ahead(pe[3], pn[3], D0, lane);
    Key between1 = whole_d0;
    if (D0 > 1) between1 = kmin(between, whole_d0);
    Key mn[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int last = e0 + j;  // index of the window's last priority in lane D0 ahead
      if (last < 4 && D0 == 0) {  // the window lies inside this lane
        Key r = q[j];
#pragma unroll
        for (int t = j + 1; t < 4; ++t)
          if (t <= last) r = kmin(r, q[t]);
        mn[j] = r;
      } else if (last < 4) {
        Key a = whole_d0;
        if (last < 3) a = ahead(pick(pe, last), pick(pn, last), D0, lane);
        Key r = kmin(se[j], a);
        if (D0 > 1) r = kmin(r, between);
        mn[j] = r;
      } else {
        Key r = kmin(se[j], ahead(pick(pe, last - 4), pick(pn, last - 4), D0 + 1, lane));
        if (D0 >= 1) r = kmin(r, between1);
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
    Key prev_min = shfl_up(mn[3]);
    if (lane == 0) {
      prev_valid = c_prev_valid;
      prev_min = c_prev_min;
    }
    unsigned start = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = (ok >> j) & 1;
      if (v && (!prev_valid || differ(mn[j], prev_min))) start |= 1u << j;
      prev_valid = v;
      prev_min = mn[j];
    }

    // distinct: against the last valid window before, which the highest
    // lane below that holds a valid window knows
    const Key lane_last = pick(mn, ok ? 31 - __clz((int)ok) : 0);  // this lane's last valid
    const unsigned holders = __ballot_sync(FULL, ok != 0);
    const int before = 31 - __clz((int)(holders & below));  // -1: none in this chunk
    Key before_min = shfl(lane_last, before & 31);
    int has = 1;
    if (before < 0) {
      has = c_has_last;
      before_min = c_last_min;
    }
    unsigned distinct = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (((start >> j) & 1) && (!has || differ(mn[j], before_min))) distinct |= 1u << j;
      if ((ok >> j) & 1) {
        has = 1;
        before_min = mn[j];
      }
    }

    const bool warm = SEG && cs < s0;  // the warm-up chunk is computed, not written
    if (!warm && p0 < s1) {  // s1 % 8 == 0: all four positions, 16- and 4-byte aligned
      const long long o = row * L + p0;
      if constexpr (ORDER == WIDE) {
        ulonglong2* om = static_cast<ulonglong2*>(out_min) + o;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          om[j] = (ok >> j) & 1 ? make_ulonglong2(mn[j].hi, mn[j].lo) : make_ulonglong2(~0ull, ~0ull);
      } else {
        ulonglong2* om = reinterpret_cast<ulonglong2*>(static_cast<u64*>(out_min) + o);
        om[0] = make_ulonglong2(ok & 1 ? mn[0] : ~0ull, ok & 2 ? mn[1] : ~0ull);
        om[1] = make_ulonglong2(ok & 4 ? mn[2] : ~0ull, ok & 8 ? mn[3] : ~0ull);
      }
      *reinterpret_cast<uint32_t*>(out_valid + o) = spread4(ok);
      *reinterpret_cast<uint32_t*>(out_start + o) = spread4(start);
      *reinterpret_cast<uint32_t*>(out_distinct + o) = spread4(distinct);
    }

    if (SEG && !warm && holders) {
      if (!c_has_last && seg > 0) {  // the segment's first valid window, with no valid window in reach
        const int fl = __ffs(holders) - 1;
        const unsigned fok = __shfl_sync(FULL, ok, fl);
        first = row * L + cs + 4 * fl + __ffs(fok) - 1;
      }
      seg_has = 1;
    }

    if (more || SEG) {
      c_prev_valid = __shfl_sync(FULL, (int)(ok >> 3), 31);
      c_prev_min = shfl(mn[3], 31);
      const Key last_min = shfl(lane_last, (31 - __clz((int)holders)) & 31);
      if (holders) {
        c_has_last = 1;
        c_last_min = last_min;
      }
    }
  }

  if constexpr (SEG) {
    if (lane == 0) {
      long long* out = summary + 4 * warp;
      out[0] = seg_has;
      out[1] = first;
      if constexpr (ORDER == WIDE) {
        out[2] = (long long)c_last_min.hi;
        out[3] = (long long)c_last_min.lo;
      } else {
        out[2] = 0;
        out[3] = (long long)c_last_min;
      }
    }
    // every lane's stores of this segment are visible to the card before the
    // row counts it
    __threadfence();
    __syncwarp();
    int arrived = 0;
    if (lane == 0) arrived = atomicAdd(counters + row, 1);
    if (__shfl_sync(FULL, arrived, 0) == nseg - 1) {  // the row's last segment to finish
      __threadfence();
      stitch_row<ORDER == WIDE ? 2 : 1>(summary + 4 * row * nseg, nseg, static_cast<const long long*>(out_min),
                                        out_distinct, lane);
      if (lane == 0) counters[row] = 0;
    }
  }
}

#define SCAN_PARAMS(Key)                                                                     \
  const uint8_t *__restrict__ packed, const uint8_t *__restrict__ vbits, long long B, int L, \
      int S, int nseg, int k, int m, int canonical, Key toggle, Key smask,                   \
      const int *__restrict__ lut, void *__restrict__ out_min, uint8_t *__restrict__ out_valid, \
      uint8_t *__restrict__ out_start, uint8_t *__restrict__ out_distinct,                  \
      long long *__restrict__ summary, int *__restrict__ counters
#define SCAN_ARGS                                                                              \
  packed, vbits, B, L, S, nseg, k, m, canonical, toggle, smask, lut, out_min, out_valid, out_start, \
      out_distinct, summary, counters

// The narrow instances: XOR or LUT.
template <int K, int M, int ORDER, bool SEG>
__global__ void __launch_bounds__(32 * WARPS) scan_kernel(SCAN_PARAMS(u64)) {
  scan_rows<K, M, ORDER, SEG>(SCAN_ARGS);
}

// The wide instances: 125 and 128 registers a thread, no stack frame; at most
// 128, so that four blocks fit an SM with the stitch inlined (136 otherwise).
template <int K, int M, bool SEG>
__global__ void __launch_bounds__(32 * WARPS, 4) scan_wide_kernel(SCAN_PARAMS(K2)) {
  scan_rows<K, M, WIDE, SEG>(SCAN_ARGS);
}

template <int K, int M, int ORDER>
int launch(const void* packed, const void* vbits, long long B, int L, int S,
           int k, int m, int canonical, typename KeyOf<ORDER>::T toggle,
           typename KeyOf<ORDER>::T smask, const void* lut, void* out_min, void* out_valid,
           void* out_start, void* out_distinct, void* summary, void* counters, void* stream) {
  if (B <= 0) return 0;
  if (S < L && (S <= 0 || S % CH)) return (int)cudaErrorInvalidValue;
  const int nseg = S >= L ? 1 : (L + S - 1) / S;
  if ((nseg > 1) != (summary != nullptr) || (nseg > 1) != (counters != nullptr) ||
      (nseg > 1 && B * nseg >= (1ll << 31)))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (B * nseg + WARPS - 1) / WARPS;
  const auto go = [&](auto kernel) {
    kernel<<<(unsigned)blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)packed, (const uint8_t*)vbits, B, L, S, nseg, k, m, canonical, toggle, smask,
        (const int*)lut, out_min, (uint8_t*)out_valid, (uint8_t*)out_start, (uint8_t*)out_distinct,
        (long long*)summary, (int*)counters);
  };
  if constexpr (ORDER == WIDE) {
    go(nseg > 1 ? scan_wide_kernel<K, M, true> : scan_wide_kernel<K, M, false>);
  } else {
    go(nseg > 1 ? scan_kernel<K, M, ORDER, true> : scan_kernel<K, M, ORDER, false>);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// packed: [B, L/4] u8, vbits: [B, L/8] u8 (encode.pack_2bit layout); L % 8 == 0,
// 1 <= m <= 31, m <= k <= m + 120. lut: null for the XOR order, else a rank
// table of 4^m int32 (m <= 15; toggle is then unused). Outputs [B, L]: int64
// minimizer (16-byte aligned), u8 valid / span_start / distinct (4-byte aligned).
// S: the segment length, L for a warp a row, else a multiple of 128 below L;
// summary: int64 [B, ceil(L / S), 4] when S < L, else null; counters: int32
// [>= B], all 0, when S < L (left all 0), else null; distinct is final either
// way. Returns the cudaError_t of the launch (0 on success).
extern "C" int stpu_scan(const void* packed, const void* vbits, long long B, int L, int S,
                         int k, int m, int canonical, unsigned long long toggle,
                         unsigned long long smask, const void* lut, void* out_min,
                         void* out_valid, void* out_start, void* out_distinct, void* summary,
                         void* counters, void* stream) {
  // Kraken 2's default k and m get their own instance, a rank table another
  auto fn = lut ? launch<0, 0, LUT> : (k == 35 && m == 31) ? launch<35, 31, XOR> : launch<0, 0, XOR>;
  return fn(packed, vbits, B, L, S, k, m, canonical, toggle, smask, lut, out_min, out_valid,
            out_start, out_distinct, summary, counters, stream);
}

// The wide scan: 32 <= m <= 63, m <= k <= m + 120; toggle and smask are the
// (hi64, lo64) limbs of the 2m-bit masks. out_min: [B, L, 2] int64 (hi64,
// lo64), 16-byte aligned; the rest as above.
extern "C" int stpu_scan_wide(const void* packed, const void* vbits, long long B, int L, int S,
                              int k, int m, int canonical, unsigned long long toggle_hi,
                              unsigned long long toggle_lo, unsigned long long smask_hi,
                              unsigned long long smask_lo, void* out_min, void* out_valid,
                              void* out_start, void* out_distinct, void* summary, void* counters,
                              void* stream) {
  return launch<0, 0, WIDE>(packed, vbits, B, L, S, k, m, canonical, K2{toggle_hi, toggle_lo},
                            K2{smask_hi, smask_lo}, nullptr, out_min, out_valid, out_start,
                            out_distinct, summary, counters, stream);
}
