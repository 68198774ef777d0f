// Radix-pass kernels for one LSD pass over u64 keys held as (lo, hi) u32
// planes: the per-block digit histogram (B1) and the stable block rank,
// which either writes ranks + histogram or scatters keys and payloads to
// their destinations (B3).
//
// B1 replaces tpu_qe/kernels/histogram.py::block_histogram; B3 replaces
// tpu_qe/kernels/histogram.py::block_rank_and_histogram, fused with the
// scatter that tpu_qe/sort/driver.py emulates with jnp.take + lax.sort.
//
// Both are bound by HBM bytes: a pass reads 8 key bytes per key in B1 and
// 8 + 4 * payloads in B3, and writes the same in B3; the arithmetic per key
// is a handful of integer ops. The design keeps every per-digit counter in
// shared memory (the digit-major histogram is the only counter traffic to
// HBM, radix * nb words), reads keys with consecutive threads on
// consecutive addresses, and needs no global atomics. The scatter writes
// runs of equal digits to consecutive addresses but is not staged through
// shared memory yet, so its stores are only partly coalesced.
//
// A ragged tail is masked (g < n), never padded: the result equals the
// sentinel-padded JAX pipeline because all-ones sentinels take the largest
// digit and sit after every real key of the last block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;             // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRadix = 256;            // digits of 1..8 bits
constexpr int kMaxPayloads = 8;

struct Planes {
  const uint32_t* in[kMaxPayloads];
  uint32_t* out[kMaxPayloads];
  int count;
};

__device__ __forceinline__ uint32_t select_digit(uint32_t lo, uint32_t hi,
                                                 int shift, int bits) {
  const uint32_t mask = (1u << bits) - 1u;
  if (shift + bits <= 32) return (lo >> shift) & mask;
  if (shift >= 32) return (hi >> (shift - 32)) & mask;
  return ((lo >> shift) | (hi << (32 - shift))) & mask;  // straddles bit 32
}

// B1: one CUDA block per key block; shared-memory atomics build the block's
// histogram, written digit-major: hist[d * nb + b].
__global__ void __launch_bounds__(kThreads)
histogram_kernel(const uint32_t* __restrict__ lo,
                 const uint32_t* __restrict__ hi, int64_t n, int64_t block,
                 int64_t nb, int shift, int bits, uint32_t* __restrict__ hist) {
  __shared__ uint32_t counts[kMaxRadix];
  const int radix = 1 << bits;
  const int64_t b = blockIdx.x;
  for (int d = threadIdx.x; d < radix; d += kThreads) counts[d] = 0;
  __syncthreads();
  const int64_t start = b * block;
  const int64_t end = start + block < n ? start + block : n;
  for (int64_t g = start + threadIdx.x; g < end; g += kThreads) {
    atomicAdd(&counts[select_digit(lo[g], hi[g], shift, bits)], 1u);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < radix; d += kThreads) {
    hist[d * nb + b] = counts[d];
  }
}

// B3: one CUDA block per key block, walked in tiles of kThreads keys. Warp w
// owns the w-th consecutive run of 32 keys of the tile, so the rank
//   popc(match_any(digit) & lanemask_lt)        (earlier lanes, same warp)
//   + count of the digit in earlier warps        (same tile)
//   + running count of the digit in earlier tiles
// is the key's occurrence index among equal digits in input order, i.e. the
// stable rank. In SCATTER mode the running count starts at the key block's
// global base (B2's exclusive scan of B1's histogram), so the rank is the
// destination itself.
template <bool SCATTER>
__global__ void __launch_bounds__(kThreads)
rank_kernel(const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
            int64_t n, int64_t block, int64_t nb, int shift, int bits,
            const uint32_t* __restrict__ base, uint32_t* __restrict__ ranks,
            uint32_t* __restrict__ hist, uint32_t* __restrict__ out_lo,
            uint32_t* __restrict__ out_hi, Planes planes) {
  __shared__ uint32_t warp_counts[kWarps][kMaxRadix];
  __shared__ uint32_t running[kMaxRadix];
  const int radix = 1 << bits;
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint32_t lanemask_lt = (1u << lane) - 1u;

  for (int d = tid; d < radix; d += kThreads) {
    running[d] = SCATTER ? base[d * nb + b] : 0u;
  }
  const int64_t start = b * block;
  const int64_t end = start + block < n ? start + block : n;
  for (int64_t t0 = start; t0 < end; t0 += kThreads) {
    for (int i = tid; i < kWarps * radix; i += kThreads) {
      warp_counts[i / radix][i % radix] = 0u;
    }
    __syncthreads();

    const int64_t g = t0 + tid;
    const bool valid = g < end;
    uint32_t l = 0u, h = 0u, d = 0xFFFFFFFFu;  // invalid lanes never match
    if (valid) {
      l = lo[g];
      h = hi[g];
      d = select_digit(l, h, shift, bits);
    }
    const uint32_t peers = __match_any_sync(0xFFFFFFFFu, d);
    const uint32_t in_warp = __popc(peers & lanemask_lt);
    if (valid && in_warp == 0) warp_counts[warp][d] = __popc(peers);
    __syncthreads();

    // Exclusive scan of each digit's count over the warps, on top of the
    // running count; one thread per digit.
    for (int dd = tid; dd < radix; dd += kThreads) {
      uint32_t s = running[dd];
      for (int w = 0; w < kWarps; ++w) {
        const uint32_t c = warp_counts[w][dd];
        warp_counts[w][dd] = s;
        s += c;
      }
      running[dd] = s;
    }
    __syncthreads();

    if (valid) {
      const uint32_t r = warp_counts[warp][d] + in_warp;
      if (SCATTER) {
        out_lo[r] = l;
        out_hi[r] = h;
        for (int p = 0; p < planes.count; ++p) planes.out[p][r] = planes.in[p][g];
      } else {
        ranks[g] = r;
      }
    }
    __syncthreads();  // warp_counts is zeroed again by the next tile
  }
  if (!SCATTER) {
    for (int d = tid; d < radix; d += kThreads) hist[d * nb + b] = running[d];
  }
}

inline int64_t num_blocks(int64_t n, int64_t block) {
  return (n + block - 1) / block;
}

}  // namespace

extern "C" {

const char* tq_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// B1. hist: (radix, nb) u32, nb = ceil(n / block). Returns cudaGetLastError.
int tq_block_histogram(const uint32_t* lo, const uint32_t* hi, int64_t n,
                       int64_t block, int shift, int bits, uint32_t* hist,
                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int64_t nb = num_blocks(n, block);
  if (nb == 0) return cudaSuccess;
  histogram_kernel<<<static_cast<unsigned>(nb), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lo, hi, n, block, nb, shift, bits, hist);
  return cudaGetLastError();
}

// B3, rank mode: ranks (n,) u32 in-block stable ranks, hist (radix, nb) u32.
int tq_block_rank_and_histogram(const uint32_t* lo, const uint32_t* hi,
                                int64_t n, int64_t block, int shift, int bits,
                                uint32_t* ranks, uint32_t* hist, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int64_t nb = num_blocks(n, block);
  if (nb == 0) return cudaSuccess;
  Planes none{};
  rank_kernel<false><<<static_cast<unsigned>(nb), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lo, hi, n, block, nb, shift, bits, nullptr, ranks, hist, nullptr,
      nullptr, none);
  return cudaGetLastError();
}

// B3, scatter mode: base is the flat exclusive scan of B1's (radix, nb)
// histogram; key words and each of the `count` u32 payload planes go to
// base[digit * nb + block] + stable rank.
int tq_rank_and_scatter(const uint32_t* lo, const uint32_t* hi, int64_t n,
                        int64_t block, int shift, int bits,
                        const uint32_t* base, uint32_t* out_lo,
                        uint32_t* out_hi, void* const* payload_in,
                        void* const* payload_out, int count, int device,
                        void* stream) {
  if (count < 0 || count > kMaxPayloads) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int64_t nb = num_blocks(n, block);
  if (nb == 0) return cudaSuccess;
  Planes planes{};
  planes.count = count;
  for (int p = 0; p < count; ++p) {
    planes.in[p] = static_cast<const uint32_t*>(payload_in[p]);
    planes.out[p] = static_cast<uint32_t*>(payload_out[p]);
  }
  rank_kernel<true><<<static_cast<unsigned>(nb), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lo, hi, n, block, nb, shift, bits, base, nullptr, nullptr, out_lo,
      out_hi, planes);
  return cudaGetLastError();
}

}  // extern "C"
