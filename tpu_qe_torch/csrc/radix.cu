// Radix-pass kernels for one LSD pass over u64 keys held as (lo, hi) u32
// planes: the per-block digit histogram (B1) and the stable block rank,
// which either writes ranks + histogram or scatters keys and payloads to
// their destinations (B3).
//
// B1 replaces tpu_qe/kernels/histogram.py::block_histogram; B3 replaces
// tpu_qe/kernels/histogram.py::block_rank_and_histogram, fused with the
// scatter that tpu_qe/sort/driver.py emulates with jnp.take + lax.sort.
//
// Both are bound by HBM bytes. B1 and B3's rank mode read only the key
// words that the digit covers: 4 bytes per key, 8 if the digit straddles
// bit 32; the rank mode writes a 4-byte rank. B3's scatter reads and writes
// 8 + 4 * payloads bytes per key. The arithmetic per key is a handful of
// integer ops. The design keeps every per-digit counter in
// shared memory (the digit-major histogram is the only counter traffic to
// HBM, radix * nb words), reads keys with consecutive threads on
// consecutive addresses, and needs no global atomics. The scatter writes
// runs of equal digits to consecutive addresses but is not staged through
// shared memory yet, so its stores are only partly coalesced.
//
// A ragged tail is masked (g < n), never padded: the result equals the
// sentinel-padded JAX pipeline because all-ones sentinels take the largest
// digit and sit after every real key of the last block.
//
// Digits of 1..8 bits take the kernels above the "wide digits" line; 9..16
// bits (as the JAX kernels and SortConfig allow) take the wide kernels,
// whose per-digit counters do not fit the 8-bit path's static tables: one
// u16 counter per digit, two to a word, in dynamic shared memory (radix * 2
// bytes, 128 KB at 16 bits). A block then holds at most 65535 keys, so no
// counter carries into its neighbour. The wide rank drops the per-warp
// table: the 8 warps of a tile take turns against the one running table,
// and the scatter reads each key's (digit, block) base from global memory.
// They are simple and right, not tuned.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;             // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRadix = 256;            // digits of 1..8 bits
constexpr int kMaxPayloads = 8;
constexpr int kMaxWideBits = 16;          // wide digits: 9..16 bits
constexpr int64_t kMaxWideBlock = 65535;  // keys per block with u16 counters

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

// The digit of key g, loading only the words it covers (the condition is
// the same for every thread, so it costs no divergence). B3's rank mode
// loads one key per thread between barriers, where the choice costs
// nothing measurable.
__device__ __forceinline__ uint32_t load_digit(const uint32_t* __restrict__ lo,
                                               const uint32_t* __restrict__ hi,
                                               int64_t g, int shift, int bits) {
  const uint32_t l = shift < 32 ? lo[g] : 0u;
  const uint32_t h = shift + bits > 32 ? hi[g] : 0u;
  return select_digit(l, h, shift, bits);
}

// B1: one CUDA block per key block; shared-memory atomics build the block's
// histogram, written digit-major: hist[d * nb + b]. LO and HI say which key
// words the digit covers; only those are loaded. Fixing them at compile
// time keeps the loop's loads unconditional (a runtime choice, as in
// load_digit, made this loop about a third slower on an H100).
template <bool LO, bool HI>
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
    atomicAdd(&counts[select_digit(LO ? lo[g] : 0u, HI ? hi[g] : 0u, shift,
                                   bits)], 1u);
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
      if (SCATTER) {   // both words move to the destination
        l = lo[g];
        h = hi[g];
        d = select_digit(l, h, shift, bits);
      } else {
        d = load_digit(lo, hi, g, shift, bits);
      }
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

// ---------------------------------------------------------------- wide digits

__device__ __forceinline__ void add_u16(uint32_t* words, uint32_t d,
                                        uint32_t v) {
  atomicAdd(&words[d >> 1], v << ((d & 1u) * 16u));
}

__device__ __forceinline__ uint32_t get_u16(const uint32_t* words,
                                            uint32_t d) {
  return (words[d >> 1] >> ((d & 1u) * 16u)) & 0xFFFFu;
}

// B1 for 9..16-bit digits: u16 counters in dynamic shared memory.
__global__ void __launch_bounds__(kThreads)
histogram_wide_kernel(const uint32_t* __restrict__ lo,
                      const uint32_t* __restrict__ hi, int64_t n,
                      int64_t block, int64_t nb, int shift, int bits,
                      uint32_t* __restrict__ hist) {
  extern __shared__ uint32_t words[];
  const int radix = 1 << bits;
  const int64_t b = blockIdx.x;
  for (int w = threadIdx.x; w < radix / 2; w += kThreads) words[w] = 0u;
  __syncthreads();
  const int64_t start = b * block;
  const int64_t end = start + block < n ? start + block : n;
  for (int64_t g = start + threadIdx.x; g < end; g += kThreads) {
    add_u16(words, load_digit(lo, hi, g, shift, bits), 1u);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < radix; d += kThreads) {
    hist[d * nb + b] = get_u16(words, d);
  }
}

// B3 for 9..16-bit digits. The in-warp rank comes from match_any as in
// rank_kernel; the warps of a tile then take turns, in warp order, against
// one table of running in-block counts: warp w reads each key's base, then
// one leader per match group adds the group's size, and a barrier passes
// the turn on. So the rank is the key's occurrence index among equal digits
// of its block in input order. SCATTER adds the (digit, block) base from
// B2's scan, read from global memory.
template <bool SCATTER>
__global__ void __launch_bounds__(kThreads)
rank_wide_kernel(const uint32_t* __restrict__ lo,
                 const uint32_t* __restrict__ hi, int64_t n, int64_t block,
                 int64_t nb, int shift, int bits,
                 const uint32_t* __restrict__ base,
                 uint32_t* __restrict__ ranks, uint32_t* __restrict__ hist,
                 uint32_t* __restrict__ out_lo, uint32_t* __restrict__ out_hi,
                 Planes planes) {
  extern __shared__ uint32_t words[];
  const int radix = 1 << bits;
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint32_t lanemask_lt = (1u << lane) - 1u;

  for (int w = tid; w < radix / 2; w += kThreads) words[w] = 0u;
  __syncthreads();
  const int64_t start = b * block;
  const int64_t end = start + block < n ? start + block : n;
  for (int64_t t0 = start; t0 < end; t0 += kThreads) {
    const int64_t g = t0 + tid;
    const bool valid = g < end;
    uint32_t l = 0u, h = 0u, d = 0xFFFFFFFFu;  // invalid lanes never match
    if (valid) {
      if (SCATTER) {
        l = lo[g];
        h = hi[g];
        d = select_digit(l, h, shift, bits);
      } else {
        d = load_digit(lo, hi, g, shift, bits);
      }
    }
    const uint32_t peers = __match_any_sync(0xFFFFFFFFu, d);
    const uint32_t in_warp = __popc(peers & lanemask_lt);
    uint32_t r = 0u;
    for (int w = 0; w < kWarps; ++w) {
      if (warp == w) {
        if (valid) r = get_u16(words, d) + in_warp;
        __syncwarp();
        if (valid && in_warp == 0) add_u16(words, d, __popc(peers));
      }
      __syncthreads();
    }
    if (valid) {
      if (SCATTER) {
        const uint32_t dst = base[d * nb + b] + r;
        out_lo[dst] = l;
        out_hi[dst] = h;
        for (int p = 0; p < planes.count; ++p) {
          planes.out[p][dst] = planes.in[p][g];
        }
      } else {
        ranks[g] = r;
      }
    }
  }
  if (!SCATTER) {
    __syncthreads();
    for (int d = tid; d < radix; d += kThreads) {
      hist[d * nb + b] = get_u16(words, d);
    }
  }
}

// Dynamic shared memory of the wide kernels, set on every call (above 48 KB
// a kernel takes it only after this attribute).
template <typename Kernel>
cudaError_t wide_smem(Kernel kernel, int bits, size_t* bytes) {
  *bytes = static_cast<size_t>(1) << bits << 1;  // radix u16 counters
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*bytes));
}

inline bool wide_args_ok(int bits, int64_t block) {
  return bits <= kMaxWideBits && block <= kMaxWideBlock;
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
  if (bits > 8) {
    if (!wide_args_ok(bits, block)) return cudaErrorInvalidValue;
    size_t bytes;
    err = wide_smem(histogram_wide_kernel, bits, &bytes);
    if (err != cudaSuccess) return err;
    histogram_wide_kernel<<<static_cast<unsigned>(nb), kThreads, bytes,
                            static_cast<cudaStream_t>(stream)>>>(
        lo, hi, n, block, nb, shift, bits, hist);
    return cudaGetLastError();
  }
  const auto kernel = shift >= 32          ? histogram_kernel<false, true>
                      : shift + bits <= 32 ? histogram_kernel<true, false>
                                           : histogram_kernel<true, true>;
  kernel<<<static_cast<unsigned>(nb), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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
  if (bits > 8) {
    if (!wide_args_ok(bits, block)) return cudaErrorInvalidValue;
    size_t bytes;
    err = wide_smem(rank_wide_kernel<false>, bits, &bytes);
    if (err != cudaSuccess) return err;
    rank_wide_kernel<false><<<static_cast<unsigned>(nb), kThreads, bytes,
                              static_cast<cudaStream_t>(stream)>>>(
        lo, hi, n, block, nb, shift, bits, nullptr, ranks, hist, nullptr,
        nullptr, none);
    return cudaGetLastError();
  }
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
  if (bits > 8) {
    if (!wide_args_ok(bits, block)) return cudaErrorInvalidValue;
    size_t bytes;
    err = wide_smem(rank_wide_kernel<true>, bits, &bytes);
    if (err != cudaSuccess) return err;
    rank_wide_kernel<true><<<static_cast<unsigned>(nb), kThreads, bytes,
                             static_cast<cudaStream_t>(stream)>>>(
        lo, hi, n, block, nb, shift, bits, base, nullptr, nullptr, out_lo,
        out_hi, planes);
    return cudaGetLastError();
  }
  rank_kernel<true><<<static_cast<unsigned>(nb), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lo, hi, n, block, nb, shift, bits, base, nullptr, nullptr, out_lo,
      out_hi, planes);
  return cudaGetLastError();
}

}  // extern "C"
