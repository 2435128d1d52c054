// Exact-match index probe through a prefix directory.
//
// Replaces the Pallas kernel `_probe_kernel` / `lookup_taxa_dma`
// (slacken_tpu/ops/pallas_kernels.py:98,182), which finds the 128-key block
// of a query through a fence of every 128th sorted key held in VMEM and
// pipelines block DMAs. Outputs equal the plain twin
// `slacken_tpu_torch.ops.lookup.lookup_taxa` (torch.searchsorted): the taxon
// of an equal key, or 0 on a miss, for any int64 query.
//
// Design. Keys are minimizer priorities: after the canonical minimum, the
// XOR toggle and the spaced mask they spread over their top bits. So the
// index carries a directory (lookup.build_directory): starts[p] is the
// position of the first key whose top b bits are >= p, with b chosen so
// that a bucket holds about 4 keys, one 32-byte sector. One thread per query
// takes the prefix p = x >> shift, loads starts[p], and scans the sorted keys
// forward from there, four at a time with two 16-byte loads in flight together,
// until one is >= x; it loads the taxon on a hit. The scan needs no bucket
// end: the first key of the next bucket already exceeds x. It starts at the
// even position at or below starts[p] so that the 16-byte loads are aligned;
// the one key this may add lies in an earlier bucket and is below x. A query
// outside the keys' range (negative, or above the widest key's prefix:
// garbage at invalid windows) misses without touching memory. The walk is
// exact for any bucket size, so skew costs time, never correctness.
//
// Bound: the rate at which L2 (or device memory, once the index outgrows
// the 50 MB L2) serves scattered 32-byte sectors, not the bytes streamed:
// queries in and taxa out are 12 bytes a query, while every load of a random
// query lands in another sector. A bisection of the whole array touches about
// log2(N) - 5 sectors that miss L1 and makes as many dependent loads; this
// walk touches 3 to 4 (directory, one or two of keys, taxa) in 4 loads. Timed
// beside it on an H100 (PERF.md, Findings): a bisection of the bucket and a
// scan of the bucket between starts[p] and starts[p + 1], each at 2 to 64
// keys a bucket; fewer and wider loads won at every index size. One thread
// per query keeps the most loads in flight: a warp per query measured 7-22x
// slower. Queries and results pass through with streaming loads and stores,
// which leaves the L2 to the index.
//
// Wide keys (m > 31; `lookup_taxa_routed_wide`, slacken_tpu/ops/lookup.py:161,
// a bisection over four 32-bit limbs there) take the same walk over 16-byte
// keys: rows (hi64, lo64) of an interleaved [n, 2] array, so a key is one
// 16-byte load, two keys one sector, where the narrow walk has four. The
// prefix is the top of the 128-bit query; an invalid window's query, -1 in
// both limbs, has a prefix beyond every bucket and misses without a load.
// The same number of scattered loads a hit as the narrow kernel, twice the
// key bytes a scan step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
probe_kernel(const long long* __restrict__ keys, const int* __restrict__ taxa, long long n,
             const int* __restrict__ starts, unsigned long long buckets, int shift,
             const long long* __restrict__ queries, long long nq, int* __restrict__ out) {
  const long long qi = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (qi >= nq) return;
  const long long x = __ldcs(queries + qi);  // streamed: the index keeps the L2
  // logical shift: a negative query gets a prefix >= 2^(63 - shift) >= buckets
  const unsigned long long p = (unsigned long long)x >> shift;
  int taxon = 0;
  if (p < buckets) {
    long long i = __ldg(starts + p) & ~1;
    while (i + 3 < n) {
      const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(keys + i));
      const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(keys + i + 2));
      if (b.y < x) {  // all four below x
        i += 4;
        continue;
      }
      const int j = a.x == x ? 0 : a.y == x ? 1 : b.x == x ? 2 : b.y == x ? 3 : -1;
      if (j >= 0) taxon = __ldg(taxa + i + j);
      i = n;  // found, or passed where x would be
    }
    for (; i < n; ++i) {  // the last keys of the index, fewer than four
      const long long key = __ldg(keys + i);
      if (key >= x) {
        if (key == x) taxon = __ldg(taxa + i);
        break;
      }
    }
  }
  __stcs(out + qi, taxon);
}

struct K2 {
  unsigned long long hi, lo;
};

__device__ __forceinline__ K2 load2(const ulonglong2* p) {
  const ulonglong2 v = __ldg(p);
  return K2{v.x, v.y};
}

__device__ __forceinline__ bool less2(const K2& a, const K2& b) {
  return a.hi < b.hi || (a.hi == b.hi && a.lo < b.lo);
}

__device__ __forceinline__ bool equal2(const K2& a, const K2& b) {
  return a.hi == b.hi && a.lo == b.lo;
}

__global__ void __launch_bounds__(THREADS)
probe_wide_kernel(const ulonglong2* __restrict__ keys, const int* __restrict__ taxa, long long n,
                  const int* __restrict__ starts, unsigned long long buckets, int shift,
                  const ulonglong2* __restrict__ queries, long long nq, int* __restrict__ out) {
  const long long qi = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (qi >= nq) return;
  const ulonglong2 raw = __ldcs(queries + qi);  // streamed: the index keeps the L2
  const K2 x = {raw.x, raw.y};
  // the 128-bit query >> shift, as the 64 bits that can name a bucket and
  // whatever lies above them
  unsigned long long p, above;
  if (shift >= 64) {
    p = x.hi >> (shift - 64);
    above = 0;
  } else if (shift == 0) {
    p = x.lo;
    above = x.hi;
  } else {
    p = (x.hi << (64 - shift)) | (x.lo >> shift);
    above = x.hi >> shift;
  }
  int taxon = 0;
  if (above == 0 && p < buckets) {
    long long i = __ldg(starts + p) & ~1;  // even: two keys are one aligned sector
    while (i + 1 < n) {
      const K2 a = load2(keys + i), b = load2(keys + i + 1);
      if (less2(b, x)) {  // both below x
        i += 2;
        continue;
      }
      if (equal2(a, x)) taxon = __ldg(taxa + i);
      else if (equal2(b, x)) taxon = __ldg(taxa + i + 1);
      i = n;  // found, or passed where x would be
    }
    if (i + 1 == n) {  // the last key of an index of odd length
      if (equal2(load2(keys + i), x)) taxon = __ldg(taxa + i);
    }
  }
  __stcs(out + qi, taxon);
}

}  // namespace

// keys: sorted unique non-negative int64 [n], 16-byte aligned; taxa: int32
// [n]; starts: int32 [buckets + 1], the prefix directory of keys >> shift
// (0 <= shift <= 63); queries: int64 [nq]; out: int32 [nq].
// Returns the cudaError_t of the launch (0 on success).
extern "C" int stpu_probe(const void* keys, const void* taxa, long long n, const void* starts,
                          long long buckets, int shift, const void* queries, long long nq,
                          void* out, void* stream) {
  if (nq <= 0) return 0;
  const long long blocks = (nq + THREADS - 1) / THREADS;
  probe_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)keys, (const int*)taxa, n, (const int*)starts,
      (unsigned long long)buckets, shift, (const long long*)queries, nq, (int*)out);
  return (int)cudaGetLastError();
}

// keys: [n, 2] unsigned (hi64, lo64) rows sorted by value, hi64 below 2^63,
// 16-byte aligned; taxa: int32 [n]; starts: int32 [buckets + 1], the prefix
// directory of the 128-bit keys >> shift (0 <= shift <= 127); queries:
// [nq, 2], 16-byte aligned; out: int32 [nq].
// Returns the cudaError_t of the launch (0 on success).
extern "C" int stpu_probe_wide(const void* keys, const void* taxa, long long n,
                               const void* starts, long long buckets, int shift,
                               const void* queries, long long nq, void* out, void* stream) {
  if (nq <= 0) return 0;
  const long long blocks = (nq + THREADS - 1) / THREADS;
  probe_wide_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const ulonglong2*)keys, (const int*)taxa, n, (const int*)starts,
      (unsigned long long)buckets, shift, (const ulonglong2*)queries, nq, (int*)out);
  return (int)cudaGetLastError();
}
