// Bitonic sort of power-of-two chunks by the u64 key (hi, lo), carrying up
// to 8 u32 payload planes (B5).
//
// Replaces tpu_qe/kernels/bitonic.py::sort_chunks, whose TPU form runs every
// compare-exchange stage as whole-tile rolls and selects in VMEM. This is
// the same network with the same per-pair rule, so keys and payloads come
// out bit-identical to it, ties included: the pair (a at the lower index,
// b = a's partner at +j) exchanges iff (a > b) differs from "descending",
// where descending = (chunk index & k) != 0. Equal keys therefore exchange
// in descending regions; a textbook `a > b` swap would move tied payloads
// differently.
//
// Bound by shared-memory traffic and the 91 synchronised stages of a
// chunk of 8192: every stage reads both keys of each pair and writes every
// plane of the pairs that exchange. HBM sees each plane read and written
// once per launch. A tile of T elements (the largest power of two whose
// planes fit in the opt-in shared memory, at most the chunk width) is
// sorted in shared memory in one launch. Wider chunks then run, for each
// merge size k > T, the stages whose stride is >= T as one global-memory
// launch each and finish the strides < T in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPlanes = 10;     // lo, hi + 8 payloads
constexpr int kTileThreads = 512;
constexpr int kStageThreads = 256;

struct Planes {
  uint32_t* p[kMaxPlanes];
};

__device__ __forceinline__ bool key_gt(uint32_t alo, uint32_t ahi,
                                       uint32_t blo, uint32_t bhi) {
  return ahi > bhi || (ahi == bhi && alo > blo);
}

// Index of the lower element of pair `pair` at stride j: a zero bit
// inserted at bit log2(j).
__device__ __forceinline__ int64_t pair_low(int64_t pair, int64_t j) {
  return ((pair & ~(j - 1)) << 1) | (pair & (j - 1));
}

// One launch per tile of `tile` elements: load every plane into shared
// memory, run merge sizes k_lo..k_hi (powers of two) with the strides
// min(k, tile) / 2 .. 1, store back.
__global__ void __launch_bounds__(kTileThreads)
tile_kernel(Planes src, Planes dst, int np, int64_t width, int tile,
            int64_t k_lo, int64_t k_hi) {
  extern __shared__ uint32_t s[];   // [plane][tile]
  const int64_t tiles_per_chunk = width / tile;
  const int64_t chunk = blockIdx.x / tiles_per_chunk;
  const int64_t local = (blockIdx.x % tiles_per_chunk) * tile;  // in chunk
  const int64_t base = chunk * width + local;
  for (int p = 0; p < np; ++p) {
    for (int i = threadIdx.x; i < tile; i += kTileThreads) {
      s[p * tile + i] = src.p[p][base + i];
    }
  }
  __syncthreads();
  for (int64_t k = k_lo; k <= k_hi; k *= 2) {
    for (int64_t j = (k < tile ? k : tile) / 2; j >= 1; j /= 2) {
      for (int q = threadIdx.x; q < tile / 2; q += kTileThreads) {
        const int a = static_cast<int>(pair_low(q, j));
        const int b = a + static_cast<int>(j);
        const bool up = ((local + a) & k) == 0;
        if (key_gt(s[a], s[tile + a], s[b], s[tile + b]) == up) {
          for (int p = 0; p < np; ++p) {
            const uint32_t t = s[p * tile + a];
            s[p * tile + a] = s[p * tile + b];
            s[p * tile + b] = t;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int p = 0; p < np; ++p) {
    for (int i = threadIdx.x; i < tile; i += kTileThreads) {
      dst.p[p][base + i] = s[p * tile + i];
    }
  }
}

// One stage (merge size k, stride j) over every chunk, in global memory.
__global__ void __launch_bounds__(kStageThreads)
stage_kernel(Planes planes, int np, int64_t pairs, int log_half,
             int64_t width, int64_t k, int64_t j) {
  const int64_t half_mask = (int64_t{1} << log_half) - 1;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kStageThreads;
  for (int64_t q = blockIdx.x * static_cast<int64_t>(kStageThreads) +
                   threadIdx.x;
       q < pairs; q += stride) {
    const int64_t i = pair_low(q & half_mask, j);
    const int64_t a = (q >> log_half) * width + i;
    const int64_t b = a + j;
    const bool up = (i & k) == 0;
    if (key_gt(planes.p[0][a], planes.p[1][a], planes.p[0][b],
               planes.p[1][b]) == up) {
      for (int p = 0; p < np; ++p) {
        const uint32_t t = planes.p[p][a];
        planes.p[p][a] = planes.p[p][b];
        planes.p[p][b] = t;
      }
    }
  }
}

}  // namespace

extern "C" {

// Largest power-of-two tile, at most `width`, whose np planes fit in the
// opt-in shared memory of `device`; 0 on error.
int64_t tq_sort_chunks_tile(int64_t width, int np, int device) {
  int smem = 0;
  if (cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return 0;
  }
  int64_t tile = 1;
  while (tile * 2 <= width && tile * 2 * 4 * np <= smem) tile *= 2;
  return tile;
}

// planes_in/planes_out: np (2 + payloads) pointers to (nb, width) u32
// planes, lo and hi first; width a power of two. Sorts each chunk of
// planes_in into planes_out. Returns cudaGetLastError.
int tq_sort_chunks(void* const* planes_in, void* const* planes_out, int np,
                   int64_t nb, int64_t width, int device, void* stream) {
  if (np < 2 || np > kMaxPlanes || width < 1 || (width & (width - 1)) != 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nb == 0) return cudaSuccess;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t tile = tq_sort_chunks_tile(width, np, device);
  if (tile == 0) return cudaErrorInvalidValue;
  const int64_t tiles = nb * (width / tile);
  if (tiles > 0x7FFFFFFF) return cudaErrorInvalidConfiguration;
  const size_t bytes = static_cast<size_t>(tile) * 4 * np;
  err = cudaFuncSetAttribute(tile_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;

  Planes src{}, dst{};
  for (int p = 0; p < np; ++p) {
    src.p[p] = static_cast<uint32_t*>(planes_in[p]);
    dst.p[p] = static_cast<uint32_t*>(planes_out[p]);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int t = static_cast<int>(tile);
  tile_kernel<<<static_cast<unsigned>(tiles), kTileThreads, bytes, st>>>(
      src, dst, np, width, t, 2, tile);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int64_t pairs = nb * (width / 2);
  int log_half = 0;
  while ((int64_t{1} << log_half) < width / 2) ++log_half;
  const int64_t needed = (pairs + kStageThreads - 1) / kStageThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 16;
  const unsigned grid = static_cast<unsigned>(needed < cap ? needed : cap);
  for (int64_t k = 2 * tile; k <= width; k *= 2) {
    for (int64_t j = k / 2; j >= tile; j /= 2) {
      stage_kernel<<<grid, kStageThreads, 0, st>>>(dst, np, pairs, log_half,
                                                   width, k, j);
    }
    tile_kernel<<<static_cast<unsigned>(tiles), kTileThreads, bytes, st>>>(
        dst, dst, np, width, t, k, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // extern "C"
