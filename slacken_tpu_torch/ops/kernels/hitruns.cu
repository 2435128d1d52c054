// Each read's final ordered hit runs, reduced on the card for per-read output.
//
// Replaces the XLA code of `hit_runs` (slacken_tpu/ops/hitruns.py:43), which
// the JAX package compiles from a cumsum over [B, L], a cummax forward fill,
// two gathers and a one-hot extraction over [B, L, cap]; no Pallas kernel
// computes it. Outputs equal the plain twin
// `slacken_tpu_torch.ops.hitruns.hit_runs_plain` bit for bit, in the same
// [B, cap + cap/2 + 3] int32 layout: the run values ((taxon + 2) << 1 | mate,
// INT32_MIN past the row's runs), the run counts as uint16 pairs, the run
// count (above cap: overflow) and the two per-mate totals.
//
// Bound: bytes. The window taxa are read once (4 bytes a position), the
// validity bits once (1/8 byte), splits and lengths once, and the bundle
// written once; the work is a few dozen integer operations a position. At
// the bench batch ([32768, 128], cap 16) that is 21,102,592 bytes.
//
// Design. A segment of G lanes a row (G = 8 for rows of up to 128
// positions, 16 up to 256, else 32; 32 / G rows a warp), 16 consecutive
// positions a lane, so a chunk of 16 * G positions is one step; nothing of
// size [B, L, cap] exists. With a warp a row and a lane a position (or 4),
// the ballots, shuffles and the row's fixed work cost a few dozen warp
// instructions a position, and their issue, not the bytes, bounded the
// kernel: 0.022-0.025 ms at the bench batch where the same loads and writes
// alone take 0.007 (NVIDIA H100 80GB HBM3, 700 W). 16 positions a lane and
// several rows a warp share that work. Before anything
// waits, a segment requests its row's split and length, the first chunk's
// window taxa (four 16-byte loads a lane; L is a multiple of 8 and the
// tensor 16-byte aligned, so every load is aligned) and the row's validity
// bits as 32-bit words (any byte offset: two aligned words and a funnel
// shift), which it keeps in shared memory so that "all k chars of the
// window are invalid" is a few word operations. The test runs only at an
// invalid window inside one mate (a bit mask from the split and length), so
// a padding row (row_lens 0) never makes it.
//
// The scan of a chunk, a lane's 16 positions as bit masks: the non-gaps;
// the value that the previous non-gap holds (from the nearest lane below in
// the segment with a non-gap, a ballot and one shuffle, else from the chunks
// before), carried through the lane's positions in order, marks the run
// starts where the value changes; the first mate-2 non-gap starts a run
// when a mate-1 non-gap precedes it, the row's first non-gap always. A
// segment scan (shuffles up) of the lanes' packed counts of non-gaps, run
// starts and mate-2 non-gaps gives each start its run id and its place
// among the row's non-gap positions. A start whose id is below cap keeps
// its value (the lane's window taxa, staged in shared memory) and its place
// in shared memory (id cap keeps its place only), so run j's count is the
// place of run j + 1 (or the row's non-gap total) less its own. The lanes
// of the segment then write the row's bundle.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int PER_LANE = 16;  // positions a lane of hit_runs_kernel scans a step
constexpr int INVALID_WINDOW = -3;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned LANE_BITS = (1u << PER_LANE) - 1u;

// A lane's positions j < b (b may lie outside [0, 16]) as a bit mask.
__device__ __forceinline__ unsigned below(int b) {
  return b <= 0 ? 0u : b >= PER_LANE ? LANE_BITS : (1u << b) - 1u;
}

// 32 validity bits of the row from bit b (bits past the row's words clear).
__device__ __forceinline__ uint32_t bits32(const uint32_t* bits, int words, int b) {
  const int w = b >> 5;
  return __funnelshift_r(w < words ? bits[w] : 0u, w + 1 < words ? bits[w + 1] : 0u, (unsigned)b & 31u);
}

// The lane's positions j (p0 + j, j < 16) whose window of k chars is all
// invalid, as a bit mask. Below 16 chars, an AND of the invalid bits shifted
// over the window in doubling steps; else a window is the rest of the
// lane's 16 chars from j, the chars p0 + 16 to p0 + k (the same for every j)
// and j chars from p0 + k. Exact where p0 + j + k is at most the row's
// length.
__device__ __forceinline__ unsigned all_invalid16(const uint32_t* bits, int words, int p0, int k) {
  if (k < PER_LANE) {
    uint32_t r = ~bits32(bits, words, p0);
    int have = 1;  // bit j of r: chars p0 + j to p0 + j + have all invalid
    for (; 2 * have <= k; have *= 2) r &= r >> have;
    return r & (r >> (k - have)) & LANE_BITS;
  }
  for (int q = p0 + PER_LANE, end = p0 + k; q < end;) {  // the middle, whole words where it can
    const int off = q & 31, n = min(32 - off, end - q);
    uint32_t w = bits[q >> 5] >> off;
    if (n < 32) w &= (1u << n) - 1u;
    if (w) return 0u;
    q += n;
  }
  const unsigned head_valid = bits32(bits, words, p0) & LANE_BITS;  // valid chars of the lane's own 16
  const unsigned head = head_valid ? LANE_BITS & ~((2u << (31 - __clz(head_valid))) - 1u) : LANE_BITS;
  const int tail_invalid = __ffs(bits32(bits, words, p0 + k)) - 1;  // invalid chars from p0 + k, -1: 32
  return head & (tail_invalid < 0 ? LANE_BITS : below(tail_invalid + 1));
}

// The 4 window taxa from position p; positions past L are invalid.
__device__ __forceinline__ int4 load4(const int* trow, int p, int L) {
  if (p < L) return __ldg(reinterpret_cast<const int4*>(trow + p));
  return make_int4(INVALID_WINDOW, INVALID_WINDOW, INVALID_WINDOW, INVALID_WINDOW);
}

// The row's validity bits from pack_2bit's bytes at any offset into `bits`,
// word i by lanes i = first, first + step, ...
__device__ __forceinline__ void copy_bits(uint32_t* bits, const uint8_t* valid, long long row, int L, int first,
                                          int step) {
  const int words = (L + 31) >> 5, nbytes = L >> 3;
  const uintptr_t vaddr = reinterpret_cast<uintptr_t>(valid) + (uintptr_t)(row * nbytes);
  const uint32_t* aligned = reinterpret_cast<const uint32_t*>(vaddr & ~(uintptr_t)3);
  const unsigned shift = 8u * (unsigned)(vaddr & 3);
  const int nwords = (int)((vaddr & 3) + nbytes + 3) >> 2;  // aligned words holding the row's bytes
  for (int i = first; i < words; i += step) {
    const uint32_t lo = __ldg(aligned + i);
    const uint32_t hi = shift && i + 1 < nwords ? __ldg(aligned + i + 1) : 0u;
    uint32_t w = __funnelshift_r(lo, hi, shift);
    const int tail = nbytes - 4 * i;  // the row's bytes from word i on
    if (tail < 4) w &= (1u << (8 * tail)) - 1u;
    bits[i] = w;
  }
}

// Shared memory a row, in 16-byte steps: 16 * G staged window taxa,
// `words` validity words, cap + 1 run starts (the non-gap positions before
// each), cap run values.
__host__ __device__ __forceinline__ int row_smem(int G, int words, int cap) {
  return (PER_LANE * G + words + 2 * cap + 1 + 3) & ~3;
}

template <int G>
__global__ void __launch_bounds__(THREADS)
hit_runs_kernel(const int* __restrict__ wt, const uint8_t* __restrict__ valid, const int* __restrict__ splits,
                const int* __restrict__ row_lens, long long rows, int L, int k, int cap, int* __restrict__ out) {
  constexpr int ROWS = 32 / G, SPAN = PER_LANE * G;
  constexpr unsigned SEG_BITS = G == 32 ? FULL : (1u << (G & 31)) - 1u;
  extern __shared__ __align__(16) uint32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int seg = lane / G, sl = lane % G;  // the row's segment of the warp, the lane in it
  const long long row = ((long long)blockIdx.x * WARPS + warp) * ROWS + seg;
  // a segment past the last row reads and writes nothing but joins the warp's ballots and shuffles
  const bool live = row < rows;
  const int words = (L + 31) >> 5;
  uint32_t* mine = smem + (size_t)(warp * ROWS + seg) * row_smem(G, words, cap);
  int* stage = reinterpret_cast<int*>(mine) + PER_LANE * sl;  // the lane's 16 window taxa
  uint32_t* bits = mine + SPAN;
  int* start = reinterpret_cast<int*>(bits + words);
  int* value = start + cap + 1;

  // every load that waits on no other, issued before anything waits
  const int split = live ? __ldg(splits + row) : -1, len = live ? __ldg(row_lens + row) : 0;
  const int* trow = wt + (live ? row : 0) * L;
  int4 q[4];
#pragma unroll
  for (int i = 0; i < 4; i++) q[i] = load4(trow, PER_LANE * sl + 4 * i, live ? L : 0);
  if (live) copy_bits(bits, valid, row, L, sl, G);
  __syncwarp();

  const bool paired = split >= 0;
  const int m_end0 = min(paired ? split : len, L), m_end1 = min(len, L);  // each mate's end
  int runs = 0, nongaps = 0, mate2 = 0;     // runs started, non-gap positions, those of mate 2
  int last_v = 0, last_p = 0;               // the last non-gap's value and position, of the chunks before
  bool have_last = false;
  for (int c = 0; c < L; c += SPAN) {
    if (c) {
#pragma unroll
      for (int i = 0; i < 4; i++) q[i] = load4(trow, c + PER_LANE * sl + 4 * i, live ? L : 0);
    }
    int t[PER_LANE];
#pragma unroll
    for (int i = 0; i < 4; i++) {
      t[4 * i] = q[i].x;
      t[4 * i + 1] = q[i].y;
      t[4 * i + 2] = q[i].z;
      t[4 * i + 3] = q[i].w;
    }
    const int p0 = c + PER_LANE * sl;  // the lane's first position
    unsigned ng = 0;                   // non-gaps
#pragma unroll
    for (int j = 0; j < PER_LANE; j++) ng |= (unsigned)(t[j] != INVALID_WINDOW) << j;
    const unsigned m2 = paired ? LANE_BITS & ~below(split + 1 - p0) : 0u;  // mate 2: p > split
    // invalid windows inside one mate: p + k <= mate 1's end, or split < p and p + k <= len
    unsigned amb = (below(m_end0 - k + 1 - p0) | (m2 & below(m_end1 - k + 1 - p0))) & ~ng;
    if (amb) amb &= all_invalid16(bits, words, p0, k);
    if (amb) {
#pragma unroll
      for (int j = 0; j < PER_LANE; j++) t[j] = amb >> j & 1 ? -1 : t[j];
      ng |= amb;
    }
    reinterpret_cast<int4*>(stage)[0] = make_int4(t[0], t[1], t[2], t[3]);
    reinterpret_cast<int4*>(stage)[1] = make_int4(t[4], t[5], t[6], t[7]);
    reinterpret_cast<int4*>(stage)[2] = make_int4(t[8], t[9], t[10], t[11]);
    reinterpret_cast<int4*>(stage)[3] = make_int4(t[12], t[13], t[14], t[15]);

    // the previous non-gap before the lane: the last one of the nearest lane
    // below in the segment that has one, else the chunks before
    const int hi = ng ? 31 - __clz(ng) : 0;
    const int lv = stage[hi], lp = p0 + hi;
    const unsigned has = (__ballot_sync(FULL, ng != 0) >> (seg * G)) & SEG_BITS;
    const unsigned has_below = has & ((1u << sl) - 1u);
    const int src = has_below ? 31 - __clz(has_below) : sl;
    const int sv = __shfl_sync(FULL, lv, src, G), sp = __shfl_sync(FULL, lp, src, G);
    const bool have = has_below || have_last;
    const int prev_p = has_below ? sp : last_p;
    int v = has_below ? sv : last_v;
    unsigned diff = 0;  // positions whose value differs from the previous non-gap's
#pragma unroll
    for (int j = 0; j < PER_LANE; j++) {
      diff |= (unsigned)(t[j] != v) << j;
      v = ng >> j & 1 ? t[j] : v;
    }
    unsigned st = ng & diff;  // run starts
    if (!have) st |= ng & (0u - ng);  // the row's first non-gap
    const unsigned ng2 = ng & m2;
    if (ng2) {  // the first mate-2 non-gap of the lane, after a mate-1 non-gap
      const unsigned first2 = ng2 & (0u - ng2);
      if ((ng & (first2 - 1u)) || (have && prev_p <= split)) st |= first2;
    }

    // packed counts, 10 bits each (a chunk holds at most 512 positions)
    const unsigned counts = (unsigned)__popc(ng) | (unsigned)__popc(st) << 10 | (unsigned)__popc(ng2) << 20;
    unsigned incl = counts;
#pragma unroll
    for (int d = 1; d < G; d <<= 1) {
      const unsigned up = __shfl_up_sync(FULL, incl, d, G);
      if (sl >= d) incl += up;
    }
    const unsigned total = __shfl_sync(FULL, incl, G - 1, G);
    const unsigned excl = incl - counts;
    int id = runs + (int)(excl >> 10 & 0x3ffu);
    const int place = nongaps + (int)(excl & 0x3ffu);
    for (unsigned s = st; s; s &= s - 1) {
      const int j = __ffs(s) - 1;
      if (id <= cap) start[id] = place + __popc(ng & ((1u << j) - 1u));
      if (id < cap) value[id] = (int)((((unsigned)stage[j] + 2u) << 1) | (m2 >> j & 1));
      id++;
    }
    runs += (int)(total >> 10 & 0x3ffu);
    nongaps += (int)(total & 0x3ffu);
    mate2 += (int)(total >> 20);
    const int top = has ? 31 - __clz(has) : 0;  // every lane shuffles: a segment's `has` is its own
    const int tv = __shfl_sync(FULL, lv, top, G), tp = __shfl_sync(FULL, lp, top, G);
    if (has) {
      last_v = tv;
      last_p = tp;
      have_last = true;
    }
  }
  __syncwarp();

  if (!live) return;
  const int width = cap + cap / 2 + 3;
  int* orow = out + row * width;
  for (int j = sl; j < width; j += G) {
    int w;
    if (j < cap) {
      w = j < runs ? value[j] : INT_MIN;
    } else if (j < cap + cap / 2) {
      unsigned c2[2];
#pragma unroll
      for (int h = 0; h < 2; h++) {
        const int r = 2 * (j - cap) + h;
        c2[h] = r < runs ? (unsigned)((r + 1 < runs ? start[r + 1] : nongaps) - start[r]) : 0u;
      }
      w = (int)(c2[0] | (c2[1] << 16));
    } else {
      w = j == cap + cap / 2 ? runs : j == cap + cap / 2 + 1 ? nongaps - mate2 : mate2;
    }
    orow[j] = w;
  }
}

// A measurement on no path: what the kernel cannot beat. The same grid and
// the same loads (a segment of G lanes a row: its split and length, its
// window taxa 16 positions a lane a chunk, its validity words), and a
// bundle of the same size written from their xor; no scan.
template <int G>
__global__ void __launch_bounds__(THREADS)
hit_runs_floor_kernel(const int* __restrict__ wt, const uint8_t* __restrict__ valid, const int* __restrict__ splits,
                      const int* __restrict__ row_lens, long long rows, int L, int cap, int* __restrict__ out) {
  constexpr int ROWS = 32 / G, SPAN = PER_LANE * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, sl = lane % G;
  const long long row = ((long long)blockIdx.x * WARPS + warp) * ROWS + lane / G;
  if (row >= rows) return;
  unsigned x = (unsigned)(__ldg(splits + row) ^ __ldg(row_lens + row));
  const int* trow = wt + row * L;
  int4 q[4];
#pragma unroll
  for (int i = 0; i < 4; i++) q[i] = load4(trow, PER_LANE * sl + 4 * i, L);
  const int words = (L + 31) >> 5, nbytes = L >> 3;
  const uintptr_t vaddr = reinterpret_cast<uintptr_t>(valid) + (uintptr_t)(row * nbytes);
  const uint32_t* aligned = reinterpret_cast<const uint32_t*>(vaddr & ~(uintptr_t)3);
  const int nwords = (int)((vaddr & 3) + nbytes + 3) >> 2;
  for (int i = sl; i < words; i += G)
    x ^= __ldg(aligned + i) ^ ((vaddr & 3) && i + 1 < nwords ? __ldg(aligned + i + 1) : 0u);
  for (int c = 0; c < L; c += SPAN) {
    if (c) {
#pragma unroll
      for (int i = 0; i < 4; i++) q[i] = load4(trow, c + PER_LANE * sl + 4 * i, L);
    }
#pragma unroll
    for (int i = 0; i < 4; i++) x ^= (unsigned)(q[i].x ^ q[i].y ^ q[i].z ^ q[i].w);
  }
  const int width = cap + cap / 2 + 3;
  int* orow = out + row * width;
  for (int j = sl; j < width; j += G) orow[j] = (int)(x ^ (unsigned)j);
}

}  // namespace

// wt: [rows, L] int32 window taxa, 16-byte aligned; valid: [rows, L/8] uint8
// bitmask (L a multiple of 8, below 2^16); splits, row_lens: [rows] int32;
// out: [rows, cap + cap/2 + 3] int32 (cap even).
extern "C" int stpu_hit_runs(const void* wt, const void* valid, const void* splits, const void* row_lens,
                             long long rows, int L, int k, int cap, void* out, void* stream) {
  if (rows <= 0) return 0;
  // lanes a row: the fewest whose chunk (16 a lane) covers the row, at most a warp
  const int G = L <= 8 * PER_LANE ? 8 : L <= 16 * PER_LANE ? 16 : 32;
  const int words = (L + 31) >> 5, rows_a_block = WARPS * (32 / G);
  const size_t smem = (size_t)rows_a_block * row_smem(G, words, cap) * sizeof(uint32_t);
  auto kernel = G == 8 ? hit_runs_kernel<8> : G == 16 ? hit_runs_kernel<16> : hit_runs_kernel<32>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (rows + rows_a_block - 1) / rows_a_block;
  kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)wt, (const uint8_t*)valid, (const int*)splits, (const int*)row_lens, rows, L, k, cap, (int*)out);
  return (int)cudaGetLastError();
}

// The floor of stpu_hit_runs (hit_runs_floor_kernel), same arguments but k.
extern "C" int stpu_hit_runs_floor(const void* wt, const void* valid, const void* splits, const void* row_lens,
                                   long long rows, int L, int cap, void* out, void* stream) {
  if (rows <= 0) return 0;
  const int G = L <= 8 * PER_LANE ? 8 : L <= 16 * PER_LANE ? 16 : 32, rows_a_block = WARPS * (32 / G);
  auto kernel = G == 8 ? hit_runs_floor_kernel<8> : G == 16 ? hit_runs_floor_kernel<16> : hit_runs_floor_kernel<32>;
  const long long blocks = (rows + rows_a_block - 1) / rows_a_block;
  kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)wt, (const uint8_t*)valid, (const int*)splits, (const int*)row_lens, rows, L, cap, (int*)out);
  return (int)cudaGetLastError();
}
