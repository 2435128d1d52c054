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
// Design. One warp a row, walking the row in tiles of 32 positions, one a
// lane; nothing of size [B, L, cap] exists. The warp first copies the row's
// validity bits (pack_2bit's little-endian bitmask, L/8 bytes) into shared
// memory as 32-bit words, so that "all k chars of the window are invalid" is
// a few word operations; the test runs only where the window is invalid and
// could be ambiguous (inside one mate), so a padding row (row_lens 0) never
// makes it. Per tile a ballot of the non-gap positions gives each lane the
// previous non-gap lane (the highest set bit below it), whose (value, mate)
// comes by a shuffle; the first non-gap lane of a tile compares with the
// (value, mate) carried from the tiles before. A ballot of the run starts
// gives each start its run id (the runs before the tile plus the starts
// below it), and the non-gap ballot its place among the row's non-gap
// positions. A start whose id is below cap keeps its value and its place in
// shared memory (id cap keeps its place only), so run j's count is the place
// of run j + 1 (or the row's non-gap total) less its own. The lanes then
// write the row's bundle.
//
// Bound: bytes. The window taxa are read once (4 bytes a position), the
// validity bits once (1/8 byte), splits and lengths once, and the bundle
// written once; the work is a few dozen integer operations a position. At
// the bench batch ([32768, 128], cap 16) that is 21,102,592 bytes.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int INVALID_WINDOW = -3;
constexpr unsigned FULL = 0xffffffffu;

// True when bits [p, p + k) of the row's validity words are all clear.
__device__ __forceinline__ bool all_invalid(const uint32_t* bits, int p, int k) {
  const int end = p + k;
  for (int q = p; q < end;) {
    const int off = q & 31;
    const int n = min(32 - off, end - q);
    uint32_t w = bits[q >> 5] >> off;
    if (n < 32) w &= (1u << n) - 1u;
    if (w) return false;
    q += n;
  }
  return true;
}

// Shared memory a warp: `words` validity words, cap + 1 run starts (the
// non-gap positions before each), cap run values.
__global__ void __launch_bounds__(THREADS)
hit_runs_kernel(const int* __restrict__ wt, const uint8_t* __restrict__ valid, const int* __restrict__ splits,
                const int* __restrict__ row_lens, long long rows, int L, int k, int cap, int* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + warp;
  if (row >= rows) return;  // the whole warp: row is the same in every lane
  const int words = (L + 31) >> 5;
  uint32_t* bits = smem + (size_t)warp * (words + 2 * cap + 1);
  int* start = reinterpret_cast<int*>(bits + words);
  int* value = start + cap + 1;

  const int nbytes = L >> 3;
  const uint8_t* vrow = valid + row * nbytes;
  for (int i = lane; i < words; i += 32) {
    uint32_t w = 0;
#pragma unroll
    for (int j = 0; j < 4; j++) {
      const int b = 4 * i + j;
      if (b < nbytes) w |= (uint32_t)vrow[b] << (8 * j);
    }
    bits[i] = w;
  }
  __syncwarp();

  const int split = splits[row], len = row_lens[row];
  const bool paired = split >= 0;
  const int* trow = wt + row * L;
  const unsigned below_me = (1u << lane) - 1u;
  int runs = 0, nongaps = 0, mate2 = 0;  // runs started, non-gap positions, those of mate 2
  int last_v = 0, last_m = 0;            // the last non-gap (value, mate) of the tiles before
  bool have_last = false;
  for (int base = 0; base < L; base += 32) {
    const int p = base + lane;
    bool nongap = false;
    int v = -1, mate = 0;
    if (p < L) {
      const int t = trow[p];
      mate = (paired && p > split) ? 1 : 0;
      if (t != INVALID_WINDOW) {
        nongap = true;
        v = t;
      } else {
        const int m_start = mate ? split + 1 : 0;
        const int m_end = (paired && !mate) ? split : len;
        nongap = p >= m_start && p + k <= m_end && p + k <= L && all_invalid(bits, p, k);
      }
    }
    const unsigned ng = __ballot_sync(FULL, nongap);
    const unsigned ng_below = ng & below_me;
    const int src = ng_below ? 31 - __clz(ng_below) : lane;
    const int prev_v = __shfl_sync(FULL, v, src);
    const int prev_m = __shfl_sync(FULL, mate, src);
    const bool is_start = nongap && (ng_below ? (prev_v != v || prev_m != mate)
                                              : (!have_last || last_v != v || last_m != mate));
    const unsigned st = __ballot_sync(FULL, is_start);
    if (is_start) {
      const int id = runs + __popc(st & below_me);
      if (id <= cap) start[id] = nongaps + __popc(ng_below);
      if (id < cap) value[id] = (int)((((unsigned)v + 2u) << 1) | (unsigned)mate);
    }
    runs += __popc(st);
    nongaps += __popc(ng);
    mate2 += __popc(__ballot_sync(FULL, nongap && mate));
    if (ng) {
      const int hi = 31 - __clz(ng);
      last_v = __shfl_sync(FULL, v, hi);
      last_m = __shfl_sync(FULL, mate, hi);
      have_last = true;
    }
  }
  __syncwarp();

  int* orow = out + row * (cap + cap / 2 + 3);
  for (int j = lane; j < cap; j += 32) orow[j] = j < runs ? value[j] : INT_MIN;
  for (int j = lane; j < cap / 2; j += 32) {
    unsigned c[2];
#pragma unroll
    for (int h = 0; h < 2; h++) {
      const int r = 2 * j + h;
      c[h] = r < runs ? (unsigned)((r + 1 < runs ? start[r + 1] : nongaps) - start[r]) : 0u;
    }
    orow[cap + j] = (int)(c[0] | (c[1] << 16));
  }
  if (lane == 0) {
    orow[cap + cap / 2] = runs;
    orow[cap + cap / 2 + 1] = nongaps - mate2;
    orow[cap + cap / 2 + 2] = mate2;
  }
}

}  // namespace

// wt: [rows, L] int32 window taxa; valid: [rows, L/8] uint8 bitmask (L a
// multiple of 8, below 2^16); splits, row_lens: [rows] int32; out: [rows,
// cap + cap/2 + 3] int32 (cap even).
extern "C" int stpu_hit_runs(const void* wt, const void* valid, const void* splits, const void* row_lens,
                             long long rows, int L, int k, int cap, void* out, void* stream) {
  if (rows <= 0) return 0;
  const int words = (L + 31) >> 5;
  const size_t smem = (size_t)WARPS * (words + 2 * cap + 1) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(hit_runs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (rows + WARPS - 1) / WARPS;
  hit_runs_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)wt, (const uint8_t*)valid, (const int*)splits, (const int*)row_lens, rows, L, k, cap, (int*)out);
  return (int)cudaGetLastError();
}
