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
// is on a line the warp or its neighbour loads anyway.
//
// k_sum_bool sums over the whole array before any element can be written, so
// it is one cooperative kernel whose grid meets at a barrier: every block
// counts its grid-strided share (warp shuffle, then shared memory, then one
// atomicAdd a block), the grid syncs, and every thread adds the total to its
// elements, which it reads a second time from L2. The grid is sized from the
// occupancy so that every block is resident (a cooperative launch refuses any
// other), and 16 bytes a thread a step where the pointers allow it. The
// counter needs no memset: two counters alternate by launch parity, and a
// launch zeroes the one the next launch will use.
//
// Bound: bytes. Each element is read once and written once (8 bytes an
// element) against one compare and one select.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

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

// counters: two int32 in device memory, both 0 before the first launch;
// launches on one stream alternate `parity`. Wraps like int32 addition in the
// plain twin.
__global__ void __launch_bounds__(THREADS)
sum_bool_kernel(const int* __restrict__ x, int* __restrict__ out, long long n, long long nvec,
                int* counters, int parity) {
  __shared__ int warp_sums[THREADS / 32];
  cg::grid_group grid = cg::this_grid();
  if (blockIdx.x == 0 && threadIdx.x == 0) counters[parity ^ 1] = 0;
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  const int4* __restrict__ x4 = reinterpret_cast<const int4*>(x);
  int c = 0;
  for (long long i = first; i < nvec; i += stride) {
    const int4 v = x4[i];
    c += (v.x > THRESHOLD) + (v.y > THRESHOLD) + (v.z > THRESHOLD) + (v.w > THRESHOLD);
  }
  for (long long i = 4 * nvec + first; i < n; i += stride) c += x[i] > THRESHOLD;
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x < 32) {
    c = threadIdx.x < THREADS / 32 ? warp_sums[threadIdx.x] : 0;
    for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
    if (threadIdx.x == 0 && c != 0) atomicAdd(counters + parity, c);
  }
  grid.sync();
  const unsigned total = (unsigned)__ldcg(counters + parity);
  int4* __restrict__ out4 = reinterpret_cast<int4*>(out);
  for (long long i = first; i < nvec; i += stride) {
    int4 v = __ldcg(x4 + i);
    v.x = (int)((unsigned)v.x + total);
    v.y = (int)((unsigned)v.y + total);
    v.z = (int)((unsigned)v.z + total);
    v.w = (int)((unsigned)v.w + total);
    out4[i] = v;
  }
  for (long long i = 4 * nvec + first; i < n; i += stride) out[i] = (int)((unsigned)x[i] + total);
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

// counters: two int32 of device memory that this stream's launches share
// (see sum_bool_kernel). The grid is at most what the card holds resident.
extern "C" int stpu_mask_sum_bool(const void* x, void* out, void* counters, int parity,
                                  long long rows, long long cols, void* stream) {
  long long n = rows * cols;
  if (n <= 0) return 0;
  static int resident_dev = -1, resident_blocks = 0;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev != resident_dev) {
    int per_sm = 0, sms = 0;
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sum_bool_kernel, THREADS, 0);
    if (rc != cudaSuccess) return (int)rc;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return (int)rc;
    resident_blocks = per_sm * sms;
    resident_dev = dev;
  }
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  long long nvec = aligned ? n / 4 : 0;
  const long long work = nvec > n - 4 * nvec ? nvec : n - 4 * nvec;
  long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > resident_blocks) blocks = resident_blocks;
  if (blocks < 1) return (int)cudaErrorLaunchOutOfResources;
  const int* xp = (const int*)x;
  int* op = (int*)out;
  int* cp = (int*)counters;
  void* args[] = {&xp, &op, &n, &nvec, &cp, &parity};
  rc = cudaLaunchCooperativeKernel((const void*)sum_bool_kernel, dim3((unsigned)blocks),
                                   dim3(THREADS), args, 0, (cudaStream_t)stream);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}
