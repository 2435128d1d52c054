// Fused minimizer scan for narrow (m <= 31, XOR-ordered) minimizers.
//
// Replaces the Pallas kernel `_scan_kernel` / `window_minimizers_pallas`
// (slacken_tpu/ops/pallas_kernels.py:26,42), which runs the doubling scans of
// `window_minimizers_impl` (slacken_tpu/ops/minimizers.py:367) on the TPU's
// vector unit. Outputs are those of the plain twin
// `slacken_tpu_torch.ops.minimizers.window_minimizers`, bit for bit wherever
// a window is valid (minimizer values at invalid windows are garbage in every
// implementation).
//
// Design. One block per row; the block walks the row in chunks of CH window
// positions, one thread per position. Codes are unpacked from the 2-bit wire
// format (encode.pack_2bit) straight into shared memory, so the dense [B, L]
// code matrix never exists in device memory. Each thread assembles its
// m-mer and the m-mer's reverse complement directly in a uint64_t (no
// doubling), takes the sliding minimum over the W = k - m + 1 priorities in
// shared memory and tests its k codes for validity. `distinct` needs the
// minimizer of the last valid window before each position, possibly many
// chunks back: a warp-shuffle max-scan of (valid ? position : -1) inside the
// chunk plus a carry across chunks replaces the TPU's doubling carry-forward
// (minimizers.py:417).
//
// Bound: device-memory bytes. Per position it reads 3/8 byte and writes
// 11 bytes (int64 minimizer and three u8 flags); the m-mer assembly is
// O(m) shared-memory reads per position, which the block's arithmetic hides
// at these sizes. The int64 output dominates; a later version can emit only
// span starts.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CH = 128;  // window positions per chunk == threads per block
constexpr int WARPS = CH / 32;

__device__ __forceinline__ int code_at(const uint8_t* __restrict__ packed,
                                       const uint8_t* __restrict__ vbits,
                                       int L, int p) {
  if (p >= L) return 4;
  if (!((vbits[p >> 3] >> (p & 7)) & 1)) return 4;
  return (packed[p >> 2] >> (2 * (p & 3))) & 3;
}

__global__ void __launch_bounds__(CH)
scan_kernel(const uint8_t* __restrict__ packed, const uint8_t* __restrict__ vbits,
            int L, int k, int m, int canonical, unsigned long long toggle,
            unsigned long long smask, long long* __restrict__ out_min,
            uint8_t* __restrict__ out_valid, uint8_t* __restrict__ out_start,
            uint8_t* __restrict__ out_distinct) {
  extern __shared__ unsigned long long smem[];
  const int W = k - m + 1;
  unsigned long long* prio = smem;                  // [CH + W - 1]
  unsigned long long* wmin = prio + (CH + W - 1);   // [CH]
  int* scan = reinterpret_cast<int*>(wmin + CH);    // [CH]
  int* warp_tot = scan + CH;                        // [WARPS]
  uint8_t* wvalid = reinterpret_cast<uint8_t*>(warp_tot + WARPS);  // [CH]
  uint8_t* codes = wvalid + CH;                     // [CH + k - 1]

  __shared__ unsigned long long carry_prev_min, carry_last_min;
  __shared__ int carry_prev_valid, carry_has_last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row = blockIdx.x;
  const uint8_t* rp = packed + row * (L / 4);
  const uint8_t* rv = vbits + row * (L / 8);
  const int n_mmers = CH + W - 1;
  const int n_codes = CH + k - 1;

  if (tid == 0) {
    carry_prev_valid = 0;
    carry_has_last = 0;
    carry_prev_min = 0;
    carry_last_min = 0;
  }

  for (int cs = 0; cs < L; cs += CH) {
    __syncthreads();  // previous chunk done with shared memory and carries
    for (int j = tid; j < n_codes; j += CH) codes[j] = (uint8_t)code_at(rp, rv, L, cs + j);
    __syncthreads();

    for (int j = tid; j < n_mmers; j += CH) {
      unsigned long long fwd = 0, rc = 0;
      for (int t = 0; t < m; ++t) {
        const unsigned long long c = codes[j + t] & 3u;
        fwd = (fwd << 2) | c;
        rc |= (3ull - c) << (2 * t);
      }
      const unsigned long long v = (canonical && rc < fwd) ? rc : fwd;
      prio[j] = (v ^ toggle) & smask;
    }
    __syncthreads();

    unsigned long long mn = prio[tid];
    for (int t = 1; t < W; ++t) {
      const unsigned long long x = prio[tid + t];
      mn = x < mn ? x : mn;
    }
    int valid = 1;
    for (int t = 0; t < k; ++t) valid &= codes[tid + t] < 4;
    const int pos = cs + tid;
    if (pos >= L) valid = 0;
    wmin[tid] = mn;
    wvalid[tid] = (uint8_t)valid;

    // inclusive max-scan of (valid ? tid : -1) across the chunk
    int x = valid ? tid : -1;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x = max(x, y);
    }
    if (lane == 31) warp_tot[warp] = x;
    __syncthreads();
    for (int w = 0; w < warp; ++w) x = max(x, warp_tot[w]);
    scan[tid] = x;
    __syncthreads();

    int prev_valid;
    unsigned long long prev_min;
    if (tid > 0) {
      prev_valid = wvalid[tid - 1];
      prev_min = wmin[tid - 1];
    } else {
      prev_valid = carry_prev_valid;
      prev_min = carry_prev_min;
    }
    const int start = valid && (!prev_valid || mn != prev_min);
    const int before = tid > 0 ? scan[tid - 1] : -1;
    int before_has;
    unsigned long long before_min;
    if (before >= 0) {
      before_has = 1;
      before_min = wmin[before];
    } else {
      before_has = carry_has_last;
      before_min = carry_last_min;
    }
    const int distinct = start && (!before_has || mn != before_min);

    if (pos < L) {
      const long long o = row * L + pos;
      out_min[o] = (long long)mn;
      out_valid[o] = (uint8_t)valid;
      out_start[o] = (uint8_t)start;
      out_distinct[o] = (uint8_t)distinct;
    }
    __syncthreads();  // every thread has read the carries of this chunk
    if (tid == CH - 1) {
      carry_prev_valid = wvalid[CH - 1];
      carry_prev_min = wmin[CH - 1];
      const int last = scan[CH - 1];
      if (last >= 0) {
        carry_has_last = 1;
        carry_last_min = wmin[last];
      }
    }
  }
}

}  // namespace

extern "C" size_t stpu_scan_smem_bytes(int k, int m) {
  const int W = k - m + 1;
  return sizeof(unsigned long long) * (CH + W - 1 + CH) + sizeof(int) * (CH + WARPS) +
         CH + (CH + k - 1);
}

// packed: [B, L/4] u8, vbits: [B, L/8] u8 (encode.pack_2bit layout); L % 8 == 0.
// Outputs [B, L]: int64 minimizer, u8 valid / span_start / distinct.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int stpu_scan(const void* packed, const void* vbits, long long B, int L,
                         int k, int m, int canonical, unsigned long long toggle,
                         unsigned long long smask, void* out_min, void* out_valid,
                         void* out_start, void* out_distinct, void* stream) {
  if (B <= 0) return 0;
  const size_t smem = stpu_scan_smem_bytes(k, m);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  scan_kernel<<<(unsigned)B, CH, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const uint8_t*)vbits, L, k, m, canonical, toggle, smask,
      (long long*)out_min, (uint8_t*)out_valid, (uint8_t*)out_start, (uint8_t*)out_distinct);
  return (int)cudaGetLastError();
}
