// Exact-match index probe through a prefix directory (`--probe routed`).
// The bucketed arrays of `--probe bucketed`, whose router is such a
// directory, have a kernel of their own, probe_bucketed_kernel in
// probe_tables.cu, which reads each bucket's end. A narrow index on the
// card is probed through its slot table by probe_slots_kernel there, on the
// same walk (key remainder and taxon in one 8-byte slot, as the wide slots
// below hold them in 16): probe_kernel, the directory kernel over the keys
// and taxa, is off the card's classify paths and stays, tested, as the
// yardstick of the slot kernel's timings.
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
// a bisection over four 32-bit limbs there) are probed through the index's
// slot table (lookup.build_slots), 16 bytes a record: inside bucket p every
// key is (p << shift) | r, so a slot holds the 128-bit (r << c) | f, the
// remainder above a c-bit field that is the taxon itself or its code (the
// taxon's position in a small sorted table of the index's distinct taxa,
// which stays in the L2). A hit reads its taxon with its key: the walk's
// dependent loads are the directory (starts[p] and starts[p + 1], one
// sector) and one or two sectors of slots, two slots a sector, where a
// separate taxa array cost a third, last load. The walk stops at the
// bucket's end, since the next bucket's slots do not carry its prefix; a
// slot below starts[p], loaded for the sake of 16-byte alignment, belongs
// to the previous bucket and is never matched. The query's prefix is the top
// of the 128-bit query; an invalid window's -1 in both limbs has a prefix
// beyond every bucket and misses without a load.

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

struct U128 {
  unsigned long long hi, lo;
};

__device__ __forceinline__ bool below(const ulonglong2& s, const U128& q) {
  return s.x < q.hi || (s.x == q.hi && s.y < q.lo);
}

__global__ void __launch_bounds__(THREADS)
probe_wide_kernel(const ulonglong2* __restrict__ slots, const int* __restrict__ codes,
                  const int* __restrict__ starts, unsigned long long buckets, int shift, int c,
                  const ulonglong2* __restrict__ queries, long long nq, int* __restrict__ out) {
  const long long qi = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (qi >= nq) return;
  const ulonglong2 x = __ldcs(queries + qi);  // streamed: the index keeps the L2
  // the 128-bit query >> shift, as the 64 bits that can name a bucket and
  // whatever lies above them; and r, the query modulo 2^shift
  unsigned long long p, above;
  U128 r;
  if (shift >= 64) {
    p = x.x >> (shift - 64);
    above = 0;
    r = {x.x & ((1ull << (shift - 64)) - 1), x.y};
  } else if (shift == 0) {
    p = x.y;
    above = x.x;
    r = {0, 0};
  } else {
    p = (x.x << (64 - shift)) | (x.y >> shift);
    above = x.x >> shift;
    r = {0, x.y & ((1ull << shift) - 1)};
  }
  int taxon = 0;
  if (above == 0 && p < buckets) {
    const long long start = __ldg(starts + p), end = __ldg(starts + p + 1);
    // Q = r << c (shift + c <= 128): the hit is the slot s with
    // Q <= s < Q + 2^c, that is s.hi == Q.hi and s.lo ^ Q.lo < 2^c
    const unsigned long long field = (1ull << c) - 1;
    const U128 q = {(r.hi << c) | (r.lo >> (64 - c)), r.lo << c};
    // even: two slots are one aligned sector; an empty bucket loads none
    for (long long i = start < end ? start & ~1 : end; i < end; i += 2) {
      const ulonglong2 a = __ldg(slots + i), b = __ldg(slots + min(i + 1, end - 1));
      const bool at_a = i >= start && !below(a, q);  // slot i - 1 < start is another bucket's
      if (!at_a && (i + 1 >= end || below(b, q))) continue;
      // limb by limb: a select of a whole pair would put both in local memory
      const unsigned long long hi = at_a ? a.x : b.x, lo = at_a ? a.y : b.y;
      if (hi == q.hi && (lo ^ q.lo) <= field) {
        const int f = (int)(lo & field);
        taxon = codes ? __ldg(codes + f) : f;
      }
      break;  // found, or passed where the query would be
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

// slots: [n, 2] unsigned (hi64, lo64) rows, lookup.build_slots's (r << c) | f
// in key order, 16-byte aligned; codes: int32 table of the distinct taxa, or
// null when the field is the taxon; starts: int32 [buckets + 1], the prefix
// directory of the 128-bit keys >> shift (0 <= shift <= 127), with
// 1 <= c <= 32 and shift + c <= 128; queries: [nq, 2], 16-byte aligned;
// out: int32 [nq]. Returns the cudaError_t of the launch (0 on success).
extern "C" int stpu_probe_wide(const void* slots, const void* codes, const void* starts,
                               long long buckets, int shift, int c, const void* queries,
                               long long nq, void* out, void* stream) {
  if (nq <= 0) return 0;
  const long long blocks = (nq + THREADS - 1) / THREADS;
  probe_wide_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const ulonglong2*)slots, (const int*)codes, (const int*)starts,
      (unsigned long long)buckets, shift, c, (const ulonglong2*)queries, nq, (int*)out);
  return (int)cudaGetLastError();
}
