// Exact-match index probe over a fence of block-leading keys.
//
// Replaces the Pallas kernel `_probe_kernel` / `lookup_taxa_dma`
// (slacken_tpu/ops/pallas_kernels.py:98,182): find the 128-key block that
// can hold the query through a fence holding every 128th sorted key, search
// that block, and return the taxon of an equal key or 0 on a miss. Outputs
// equal the plain twin `slacken_tpu_torch.ops.lookup.lookup_taxa`
// (torch.searchsorted).
//
// Design. One thread per query: a binary search of the fence (log2(N/128)
// steps), then of the 128-key block (7 steps). The TPU kernel keeps the
// fence in VMEM and pipelines block DMAs through an 8-slot ring; here the
// fence stays in device memory (2.6M keys give a 164 KB fence, 131M keys an
// 8.2 MB one, far over the 227 KB of shared memory a block may hold), where
// the 50 MB L2 keeps it and the hot upper levels of every search resident.
// Queries are arbitrary int64: garbage minimizers at invalid window
// positions (possibly >= 2^62) stay in bounds and simply miss.
//
// Bound: memory latency, ~log2(N) dependent loads per query. The card hides
// it with queries in flight, so a query gets one thread, not a warp: a
// warp-per-query version (coalesced 128-key block read and a ballot) kept 32x
// fewer queries in flight and measured 7-22x slower on an H100 (PERF.md,
// Findings). A shared-memory copy of the fence's top levels did not help
// either.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr long long BLOCK_KEYS = 128;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
probe_kernel(const long long* __restrict__ keys, const int* __restrict__ taxa, long long n,
             const long long* __restrict__ fence, long long nb,
             const long long* __restrict__ queries, long long nq, int* __restrict__ out) {
  const long long qi = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (qi >= nq) return;
  const long long x = queries[qi];

  // last fence entry <= x (block 0 when x precedes every key)
  long long lo = 0, hi = nb - 1;
  while (lo < hi) {
    const long long mid = (lo + hi + 1) >> 1;
    if (__ldg(fence + mid) <= x) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  // first key >= x inside the block; past the block's end every key is > x
  long long a = lo * BLOCK_KEYS;
  long long b = a + BLOCK_KEYS < n ? a + BLOCK_KEYS : n;
  while (a < b) {
    const long long mid = (a + b) >> 1;
    if (__ldg(keys + mid) < x) {
      a = mid + 1;
    } else {
      b = mid;
    }
  }
  out[qi] = (a < n && keys[a] == x) ? taxa[a] : 0;
}

}  // namespace

// keys: sorted int64 [n], n > 0; taxa: int32 [n]; fence: int64 [nb],
// fence[b] = keys[b * 128]; queries: int64 [nq]; out: int32 [nq].
// Returns the cudaError_t of the launch (0 on success).
extern "C" int stpu_probe(const void* keys, const void* taxa, long long n, const void* fence,
                          long long nb, const void* queries, long long nq, void* out,
                          void* stream) {
  if (nq <= 0) return 0;
  const long long blocks = (nq + THREADS - 1) / THREADS;
  probe_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)keys, (const int*)taxa, n, (const long long*)fence, nb,
      (const long long*)queries, nq, (int*)out);
  return (int)cudaGetLastError();
}
