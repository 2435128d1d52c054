// The five mask idioms the minimizer scan is built from, one kernel each.
//
// Replaces the Pallas micro-kernels of `exp_pallas_probe`
// (scripts/tpu_session.py:1001, bodies k_select :1023, k_astype :1027,
// k_concat :1030, k_carry :1036, k_sum_bool :1047), which isolate the
// select, bool cast, shift-by-concatenation, carry-forward select and bool
// sum that the scan kernel composes. Each takes a contiguous [rows, cols]
// int32 array with cols >= 16 and writes one of the same shape; outputs equal
// the plain twins in slacken_tpu_torch/ops/mask_idioms.py.
//
// Design. One thread per element, 256 threads a block. The row shifts of
// k_concat (left by 1) and k_carry (right by 16) index by column inside the
// row, never by flat offset, and read the neighbour from global memory: it
// is on a line the warp or its neighbour loads anyway. k_sum_bool sums over
// the whole array, so it is two kernels in stream order: a count (warp
// shuffle, then shared memory, then one atomicAdd a block into a zeroed int)
// and an add that reads the finished count.
//
// Bound: bytes. Each element is read once and written once (8 bytes an
// element) against one compare and one select.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int THRESHOLD = 64;
constexpr int CARRY_SHIFT = 16;

__global__ void __launch_bounds__(THREADS)
select_kernel(const int* __restrict__ x, int* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const bool m = x[i] > THRESHOLD;
  out[i] = m ? 1 : 0;
}

__global__ void __launch_bounds__(THREADS)
astype_kernel(const int* __restrict__ x, int* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  out[i] = static_cast<int>(x[i] > THRESHOLD);
}

// out = m & (m shifted left by one column, false shifted in at the row's end)
__global__ void __launch_bounds__(THREADS)
concat_kernel(const int* __restrict__ x, int* __restrict__ out, long long n, long long cols) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const long long col = i % cols;
  const bool m = x[i] > THRESHOLD;
  const bool next = (col + 1 < cols) && (x[i + 1] > THRESHOLD);
  out[i] = (m && next) ? 1 : 0;
}

// One step of the doubling carry-forward: where the mask is clear here and
// set 16 columns back in the same row, take the value from there.
__global__ void __launch_bounds__(THREADS)
carry_kernel(const int* __restrict__ x, int* __restrict__ out, long long n, long long cols) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const long long col = i % cols;
  const int v = x[i];
  const int pv = col >= CARRY_SHIFT ? x[i - CARRY_SHIFT] : 0;
  const bool take = !(v > THRESHOLD) && col >= CARRY_SHIFT && (pv > THRESHOLD);
  out[i] = take ? pv : v;
}

__global__ void __launch_bounds__(THREADS)
count_kernel(const int* __restrict__ x, long long n, int* __restrict__ total) {
  __shared__ int warp_sums[THREADS / 32];
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  int c = (i < n && x[i] > THRESHOLD) ? 1 : 0;
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x < 32) {
    c = threadIdx.x < THREADS / 32 ? warp_sums[threadIdx.x] : 0;
    for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
    if (threadIdx.x == 0 && c != 0) atomicAdd(total, c);
  }
}

__global__ void __launch_bounds__(THREADS)
add_count_kernel(const int* __restrict__ x, int* __restrict__ out, long long n,
                 const int* __restrict__ total) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  // wraps like int32 addition in the plain twin
  out[i] = (int)((unsigned)x[i] + (unsigned)*total);
}

inline unsigned blocks_for(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

// x, out: int32 [rows, cols], contiguous. Each returns the cudaError_t of
// its launch (0 on success).

extern "C" int stpu_mask_select(const void* x, void* out, long long rows, long long cols,
                                void* stream) {
  const long long n = rows * cols;
  if (n <= 0) return 0;
  select_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>((const int*)x, (int*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int stpu_mask_astype(const void* x, void* out, long long rows, long long cols,
                                void* stream) {
  const long long n = rows * cols;
  if (n <= 0) return 0;
  astype_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>((const int*)x, (int*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int stpu_mask_concat(const void* x, void* out, long long rows, long long cols,
                                void* stream) {
  const long long n = rows * cols;
  if (n <= 0) return 0;
  concat_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>((const int*)x, (int*)out, n,
                                                                     cols);
  return (int)cudaGetLastError();
}

extern "C" int stpu_mask_carry(const void* x, void* out, long long rows, long long cols,
                               void* stream) {
  const long long n = rows * cols;
  if (n <= 0) return 0;
  carry_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>((const int*)x, (int*)out, n,
                                                                    cols);
  return (int)cudaGetLastError();
}

// total: one int32 of scratch in device memory; zeroed here, on the stream.
extern "C" int stpu_mask_sum_bool(const void* x, void* out, void* total, long long rows,
                                  long long cols, void* stream) {
  const long long n = rows * cols;
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(total, 0, sizeof(int), s);
  if (rc != cudaSuccess) return (int)rc;
  count_kernel<<<blocks_for(n), THREADS, 0, s>>>((const int*)x, n, (int*)total);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  add_count_kernel<<<blocks_for(n), THREADS, 0, s>>>((const int*)x, (int*)out, n,
                                                     (const int*)total);
  return (int)cudaGetLastError();
}
