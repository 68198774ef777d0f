// Flat exclusive prefix sum of u32, wrapping mod 2^32 (B2).
//
// Replaces tpu_qe/kernels/scan.py::exclusive_scan. The TPU kernel is one
// pass that carries the running total in SMEM from one grid step to the
// next; Hopper blocks run in no order, so nothing carries between them.
// This is reduce-then-scan instead: (1) every block sums its chunk, (2) one
// block scans those sums, (3) every block scans its chunk again on top of
// its chunk's base. Any n is taken; there is no tiling requirement.
//
// Bound by HBM bytes: the input is read twice and the output written once,
// 12 bytes per element, and the per-chunk sums are 1/4096 of that. Inside a
// block the scan runs in registers with warp shuffles, and only the 32 warp
// totals pass through shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;  // 32 warps, so warp 0 can scan the warp totals
constexpr int kTiles = 4;       // tiles of kThreads elements per block
constexpr int64_t kChunk = int64_t{kThreads} * kTiles;
constexpr uint32_t kFull = 0xFFFFFFFFu;

// Inclusive scan of one value per thread across the block; *total receives
// the block's sum. All kThreads threads must call it.
__device__ __forceinline__ uint32_t block_inclusive_scan(uint32_t v,
                                                         uint32_t* total) {
  __shared__ uint32_t warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    uint32_t s = warp_sums[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const uint32_t out = v + (warp ? warp_sums[warp - 1] : 0u);
  *total = warp_sums[kThreads / 32 - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return out;
}

__global__ void __launch_bounds__(kThreads)
reduce_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ sums,
              int64_t n) {
  const int64_t start = int64_t{blockIdx.x} * kChunk;
  uint32_t v = 0u;
  for (int t = 0; t < kTiles; ++t) {
    const int64_t g = start + int64_t{t} * kThreads + threadIdx.x;
    if (g < n) v += x[g];
  }
  uint32_t total;
  block_inclusive_scan(v, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// One block: in-place exclusive scan of the chunk sums.
__global__ void __launch_bounds__(kThreads)
scan_sums_kernel(uint32_t* __restrict__ sums, int64_t count) {
  uint32_t carry = 0u;
  for (int64_t i0 = 0; i0 < count; i0 += kThreads) {
    const int64_t i = i0 + threadIdx.x;
    const uint32_t v = i < count ? sums[i] : 0u;
    uint32_t total;
    const uint32_t inc = block_inclusive_scan(v, &total);
    if (i < count) sums[i] = carry + inc - v;
    carry += total;
  }
}

__global__ void __launch_bounds__(kThreads)
downsweep_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                 const uint32_t* __restrict__ sums, int64_t n) {
  const int64_t start = int64_t{blockIdx.x} * kChunk;
  uint32_t carry = sums[blockIdx.x];
  for (int t = 0; t < kTiles; ++t) {
    const int64_t g = start + int64_t{t} * kThreads + threadIdx.x;
    const uint32_t v = g < n ? x[g] : 0u;
    uint32_t total;
    const uint32_t inc = block_inclusive_scan(v, &total);
    if (g < n) out[g] = carry + inc - v;
    carry += total;
  }
}

}  // namespace

extern "C" {

// Number of u32 words of scratch that tq_exclusive_scan needs for n.
int64_t tq_exclusive_scan_scratch(int64_t n) { return (n + kChunk - 1) / kChunk; }

// out[i] = x[0] + ... + x[i-1] mod 2^32. scratch holds
// tq_exclusive_scan_scratch(n) words. Returns the first launch error.
int tq_exclusive_scan(const uint32_t* x, uint32_t* out, uint32_t* scratch,
                      int64_t n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int64_t chunks = tq_exclusive_scan_scratch(n);
  if (chunks == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  reduce_kernel<<<static_cast<unsigned>(chunks), kThreads, 0, s>>>(x, scratch, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_sums_kernel<<<1, kThreads, 0, s>>>(scratch, chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  downsweep_kernel<<<static_cast<unsigned>(chunks), kThreads, 0, s>>>(
      x, out, scratch, n);
  return cudaGetLastError();
}

}  // extern "C"
