// Extended-morton key construction from quantized cells through the 9 x 256
// LUT words (B4): for each key, the OR of one LUT word per (axis, level)
// group, indexed by byte (q[axis] >> step * level) & 0xFF (step 8, or 3 for
// the shipped reference kernel's quirk), plus the 4 size bits (j >> 8)
// placed directly at bits 0, 16, 32 and 48.
//
// Replaces tpu_qe/kernels/morton.py::encode_quantized_lut, whose TPU form
// lays each 256-entry LUT out as a (2, 128) tile for 128-lane gathers.
//
// Bound by HBM bytes: 16 bytes read (q, 3 words, and j) and 8 written per
// key, against 18 shared-memory lookups and a few integer ops. The 9 x 256
// x 2 LUT words (18 KB) sit in shared memory, loaded once per block; a
// grid-stride loop over the keys amortises that load. Constant memory would
// serialise here: the lanes of a warp read different bytes. A ragged tail
// is masked, so any n is taken.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 9;          // 3 levels x 3 axes
constexpr int kLutWords = kGroups * 256;
constexpr int kBlocksPerSm = 8;     // 18 KB of LUTs each: 144 KB per SM

__global__ void __launch_bounds__(kThreads)
morton_lut_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ j,
                  const uint32_t* __restrict__ lut_lo,
                  const uint32_t* __restrict__ lut_hi, int64_t n, int step,
                  uint32_t* __restrict__ out_lo, uint32_t* __restrict__ out_hi) {
  __shared__ uint32_t s_lo[kLutWords];
  __shared__ uint32_t s_hi[kLutWords];
  for (int i = threadIdx.x; i < kLutWords; i += kThreads) {
    s_lo[i] = lut_lo[i];
    s_hi[i] = lut_hi[i];
  }
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t g = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       g < n; g += stride) {
    const uint32_t c[3] = {q[3 * g], q[3 * g + 1], q[3 * g + 2]};
    uint32_t lo = 0u, hi = 0u;
#pragma unroll
    for (int level = 0; level < 3; ++level) {
#pragma unroll
      for (int axis = 0; axis < 3; ++axis) {
        const int idx = (axis + 3 * level) * 256 +
                        static_cast<int>((c[axis] >> (step * level)) & 0xFFu);
        lo |= s_lo[idx];
        hi |= s_hi[idx];
      }
    }
    // size bit b of s = j >> 8 goes to key bit 16 * b: bits 0, 16 of lo and
    // 0, 16 of hi
    const uint32_t s = j[g] >> 8;
    lo |= (s & 1u) | (((s >> 1) & 1u) << 16);
    hi |= ((s >> 2) & 1u) | (((s >> 3) & 1u) << 16);
    out_lo[g] = lo;
    out_hi[g] = hi;
  }
}

}  // namespace

extern "C" {

// q: (n, 3) u32 row-major, j: (n,) u32, lut_lo/lut_hi: (9, 256) u32;
// out_lo/out_hi: (n,) u32. step is 8, or 3 for the quirk. Returns
// cudaGetLastError.
int tq_morton_encode_lut(const uint32_t* q, const uint32_t* j,
                         const uint32_t* lut_lo, const uint32_t* lut_hi,
                         int64_t n, int step, uint32_t* out_lo,
                         uint32_t* out_hi, int device, void* stream) {
  if (step != 8 && step != 3) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t needed = (n + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  const unsigned grid = static_cast<unsigned>(needed < cap ? needed : cap);
  morton_lut_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, j, lut_lo, lut_hi, n, step, out_lo, out_hi);
  return cudaGetLastError();
}

}  // extern "C"
