// Stable in-block rank and digit-major histogram of 8-bit digits, counted
// on the tensor cores through int8 one-hot matrix products (B6).
//
// Replaces tpu_qe/kernels/rank_mxu.py::block_rank_and_histogram_mxu; its
// output equals B3's rank mode (csrc/radix.cu) bit for bit. Each key gets a
// concatenated one-hot row of 32 bytes: X[c] = [c == high nibble] for
// c < 16 and [c - 16 == low nibble] for c >= 16. Per step of 32 keys:
//
//   X X^T[i][j] = [hi_i == hi_j] + [lo_i == lo_j],  SAME = (X X^T == 2)
//   rank_in_step[i] = sum_{j<i} SAME[i][j]
//   H += OH_hi^T OH_lo                    the running 16 x 16 histogram
//
// all as mma.sync m16n8k32 (u8 in, s32 accumulate): 6 products for the
// lower triangle of SAME and 2 for H, 8 per 32 keys. A key's base, the
// count of its digit in the earlier steps, is H as it stood before the
// step; H is summed in the s32 accumulator itself, so it is exact for any
// count. The A fragment of SAME's rows holds the same registers as the B
// fragment of its columns (B = X^T), so one fragment build serves both.
// A one-hot word is built in registers from a nibble by one clamped shift.
//
// One CUDA block per key block, taken in segments of 4096 keys. The block
// reads a segment's digits into shared memory, 8 loads in flight a thread;
// each warp ranks a contiguous run of the segment (lane (g, t) ranks key
// g + 8t of a step) and keeps the run's counts in a shared table. The
// warps' 256 totals are scanned once per segment, over the warps and on top
// of the running count of the earlier segments; then each warp stores its
// run's ranks. Three block barriers per segment. Only the key word the
// digit covers is read (both only for a digit that straddles bit 32), so
// HBM moves 8 bytes per key, as the bound counts. What bounds the kernel
// is the integer work around the products (about 150 instructions a warp
// per step, `bench/stop_early.py` in PERF.md), not the tensor cores.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRadix = 256;
constexpr int kSegment = 4096;   // keys ranked between two block barriers
constexpr uint32_t kBytes = 0x01010101u;
constexpr uint32_t kFlags = 0x10101010u;   // a histogram one-hot byte is 16

static_assert(kThreads == kRadix, "one thread per digit in the warp scan");

// Slot of digit d in a warp's table: rows of 16 by high nibble, the halves
// of every other pair of rows swapped, so that the C-fragment stores of a
// half warp fall on 32 distinct banks.
__device__ __forceinline__ int slot(uint32_t d) {
  return static_cast<int>(d ^ ((d >> 2) & 8u));
}

// x << s, and 0 for s >= 32 (PTX clamps the shift): with s = 8 (v - 4t) as
// an unsigned number, the u8 one-hot word of nibble v over columns 4t..4t+3.
__device__ __forceinline__ uint32_t shl_clamp(uint32_t x, uint32_t s) {
  uint32_t r;
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(s));
  return r;
}

// 16 in each byte of x (four nibbles) equal to the byte of v, else 0.
__device__ __forceinline__ uint32_t eq16(uint32_t x, uint32_t v) {
  return (kFlags - (x ^ v)) & kFlags;
}

// d += a (16 x 32, row) * b (32 x 8, col); u8 in, s32 accumulate.
__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The lane's C-fragment entries of H (low nibbles 0..7 in h0, 8..15 in h1;
// high nibble g in [0..1], g + 8 in [2..3]) into the warp's table.
__device__ __forceinline__ void store_counts(uint32_t* table,
                                             const int (&h0)[4],
                                             const int (&h1)[4], int g,
                                             int t) {
  const uint32_t d = 16 * g + 2 * t;
  *reinterpret_cast<uint2*>(&table[slot(d)]) = make_uint2(h0[0], h0[1]);
  *reinterpret_cast<uint2*>(&table[slot(d + 128)]) = make_uint2(h0[2], h0[3]);
  *reinterpret_cast<uint2*>(&table[slot(d + 8)]) = make_uint2(h1[0], h1[1]);
  *reinterpret_cast<uint2*>(&table[slot(d + 136)]) = make_uint2(h1[2], h1[3]);
}

// kStraddle: the digit spans both words (w0 = lo, w1 = hi); else it lies in
// w0 alone, at `shift` within that word.
template <bool kStraddle>
__global__ void __launch_bounds__(kThreads)
rank_mxu_kernel(const uint32_t* __restrict__ w0,
                const uint32_t* __restrict__ w1, int64_t n, int64_t block,
                int64_t nb, int shift, uint32_t* __restrict__ ranks,
                uint32_t* __restrict__ hist) {
  // a warp's counts (x 256) while it ranks its run, then its bases
  __shared__ __align__(16) uint32_t table[kWarps][kRadix];
  __shared__ uint32_t staged[kSegment];        // in-run rank | digit << 16
  __shared__ __align__(16) uint8_t digits[kSegment];
  __shared__ uint32_t running[kRadix];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;       // mma group, thread in group
  const int own = g + 8 * t;                   // the lane's key of a step
  const int64_t b = blockIdx.x;
  const int64_t start = b * block;
  const int64_t end = start + block < n ? start + block : n;
  uint32_t* tw = table[warp];
  const uint32_t vg = g * kBytes, vg8 = (g + 8) * kBytes;
  const uint32_t m0 = 2 * t < g ? 2u : 0u, m1 = 2 * t + 1 < g ? 2u : 0u;
  // 0x80 - 32t in each byte: see the one-hot words below
  const uint32_t bias = (0x80u - 32u * t) * kBytes;
  const int rank_shift = 8 * t + 1;
  running[tid] = 0u;

  auto digit = [&](int64_t gi) -> uint32_t {
    if (kStraddle) {
      return ((w0[gi] >> shift) | (w1[gi] << (32 - shift))) & 0xFFu;
    }
    return (w0[gi] >> shift) & 0xFFu;
  };

  for (int64_t seg = start; seg < end; seg += kSegment) {
    const int len = static_cast<int>(end - seg < kSegment ? end - seg
                                                          : kSegment);
    const int per = (len + kThreads - 1) / kThreads * 32;   // keys a warp
    const int run0 = warp * per < len ? warp * per : len;
    const int run1 = run0 + per < len ? run0 + per : len;
    // The segment's digits, with 8 loads in flight a thread: a warp that
    // loaded its own keys step by step would wait on each load.
    for (int i0 = 0; i0 < len; i0 += 8 * kThreads) {
      uint32_t v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int i = i0 + k * kThreads + tid;
        v[k] = i < len ? digit(seg + i) : 0u;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int i = i0 + k * kThreads + tid;
        if (i < len) digits[i] = static_cast<uint8_t>(v[k]);
      }
    }
    int h0[4] = {0, 0, 0, 0}, h1[4] = {0, 0, 0, 0};
    __syncwarp();   // the previous segment's ranks were read from the table
    store_counts(tw, h0, h1, g, t);
    __syncthreads();

    for (int s0 = run0; s0 < run1; s0 += 32) {
      const int valid = run1 - s0;   // keys of this step; 32 or more: all
      // (a byte past the run is stale: it only meets the SAME rows of keys
      // past the run, and the histogram masks it)
      const uint32_t d = digits[s0 + own];
      // digits of keys g, g + 8, g + 16, g + 24 (the group's lanes), a
      // byte each
      uint32_t quad = d << (8 * t);
      quad |= __shfl_xor_sync(0xFFFFFFFFu, quad, 1);
      quad |= __shfl_xor_sync(0xFFFFFFFFu, quad, 2);
      const uint2 oct = *reinterpret_cast<const uint2*>(&digits[s0 + 8 * t]);
      const uint32_t base = tw[slot(d)] >> 8;

      // H += OH_hi^T OH_lo over the step, first, so that the products are
      // done when the table is written: k = 4t + i is key 8t + i, k = 16 +
      // 4t + i key 8t + 4 + i; keys past the run are masked out of A
      uint32_t mask0 = kFlags, mask1 = kFlags;
      if (valid < 32) {
        const int c0 = min(max(valid - 8 * t, 0), 4);
        const int c1 = min(max(valid - 8 * t - 4, 0), 4);
        mask0 = c0 == 4 ? kFlags : kFlags & ((1u << (8 * c0)) - 1u);
        mask1 = c1 == 4 ? kFlags : kFlags & ((1u << (8 * c1)) - 1u);
      }
      const uint32_t x0h = (oct.x >> 4) & 0x0F0F0F0Fu;
      const uint32_t x1h = (oct.y >> 4) & 0x0F0F0F0Fu;
      const uint32_t x0l = oct.x & 0x0F0F0F0Fu, x1l = oct.y & 0x0F0F0F0Fu;
      const uint32_t ha[4] = {eq16(x0h, vg) & mask0, eq16(x0h, vg8) & mask0,
                              eq16(x1h, vg) & mask1, eq16(x1h, vg8) & mask1};
      mma(h0, ha, eq16(x0l, vg), eq16(x1l, vg));     // low nibbles 0..7
      mma(h1, ha, eq16(x0l, vg8), eq16(x1l, vg8));   // 8..15

      // SAME: rows and columns are the step's keys in order; wh/wl[k] are
      // the one-hot words of key g + 8k, columns 4t..4t+3 of each half
      // byte k: 8 (v - 4t) for nibble v of key g + 8k, from 8v + 0x80 - 32t
      // (no carry between bytes) with its top bit flipped: 0..24 for v in
      // 4t..4t+3, 32 or more otherwise, where the clamped shift gives 0
      const uint32_t sh = (((quad >> 1) & 0x78787878u) + bias) ^ 0x80808080u;
      const uint32_t sl = (((quad << 3) & 0x78787878u) + bias) ^ 0x80808080u;
      uint32_t wh[4], wl[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wh[k] = shl_clamp(1u, __byte_perm(sh, 0u, 0x4440 + k));
        wl[k] = shl_clamp(1u, __byte_perm(sl, 0u, 0x4440 + k));
      }
      const uint32_t a0[4] = {wh[0], wh[1], wl[0], wl[1]};   // keys 0..15
      const uint32_t a1[4] = {wh[2], wh[3], wl[2], wl[3]};   // keys 16..31
      int d00[4] = {0, 0, 0, 0}, d01[4] = {0, 0, 0, 0};
      int d10[4] = {0, 0, 0, 0}, d11[4] = {0, 0, 0, 0};
      int d12[4] = {0, 0, 0, 0}, d13[4] = {0, 0, 0, 0};
      mma(d00, a0, wh[0], wl[0]);   // columns: keys 0..7
      mma(d01, a0, wh[1], wl[1]);   // 8..15
      mma(d10, a1, wh[0], wl[0]);
      mma(d11, a1, wh[1], wl[1]);
      mma(d12, a1, wh[2], wl[2]);   // 16..23
      mma(d13, a1, wh[3], wl[3]);   // 24..31
      // [SAME] = entry & 2; a lane's columns are 2t, 2t + 1 of each tile;
      // m0, m1 keep those left of the diagonal tile's row
      const uint32_t rg = (d00[0] & m0) + (d00[1] & m1);
      const uint32_t rg8 = (d00[2] & 2) + (d00[3] & 2) + (d01[2] & m0) +
                           (d01[3] & m1);
      const uint32_t rg16 = (d10[0] & 2) + (d10[1] & 2) + (d11[0] & 2) +
                            (d11[1] & 2) + (d12[0] & m0) + (d12[1] & m1);
      const uint32_t rg24 = (d10[2] & 2) + (d10[3] & 2) + (d11[2] & 2) +
                            (d11[3] & 2) + (d12[2] & 2) + (d12[3] & 2) +
                            (d13[2] & m0) + (d13[3] & m1);
      uint32_t packed = rg | rg8 << 8 | rg16 << 16 | rg24 << 24;   // 2 x
      packed += __shfl_xor_sync(0xFFFFFFFFu, packed, 1);
      packed += __shfl_xor_sync(0xFFFFFFFFu, packed, 2);
      const uint32_t in_step = (packed >> rank_shift) & 0x7Fu;

      // a key past the run leaves its word in a slot no run holds
      staged[s0 + own] = (in_step + base) | d << 16;
      __syncwarp();   // every lane has read the table
      store_counts(tw, h0, h1, g, t);
      __syncwarp();
    }
    __syncthreads();

    // Exclusive scan of each digit's count over the warps (runs in input
    // order), on top of the running count of the earlier segments.
    {
      const int k = slot(tid);
      uint32_t s = running[tid];
      for (int w = 0; w < kWarps; ++w) {
        const uint32_t c = table[w][k] >> 8;
        table[w][k] = s;
        s += c;
      }
      running[tid] = s;
    }
    __syncthreads();

    for (int i = run0 + lane; i < run1; i += 32) {
      const uint32_t v = staged[i];
      ranks[seg + i] = (v & 0xFFFFu) + tw[slot(v >> 16)];
    }
    // the next segment's first barrier comes before any warp writes into
    // another warp's run of this one (runs move with the length)
  }
  hist[tid * nb + b] = running[tid];
}

}  // namespace

extern "C" {

// ranks (n,) u32 in-block stable ranks of the 8-bit digit at `shift`,
// hist (256, nb) u32 digit-major, nb = ceil(n / block). Returns
// cudaGetLastError.
int tq_block_rank_and_histogram_mxu(const uint32_t* lo, const uint32_t* hi,
                                    int64_t n, int64_t block, int shift,
                                    uint32_t* ranks, uint32_t* hist,
                                    int device, void* stream) {
  if (shift < 0 || shift > 56 || block < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int64_t nb = (n + block - 1) / block;
  if (nb == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(nb);
  if (shift > 24 && shift < 32) {
    rank_mxu_kernel<true><<<grid, kThreads, 0, s>>>(lo, hi, n, block, nb,
                                                    shift, ranks, hist);
  } else {
    // only the word the digit lies in is read
    rank_mxu_kernel<false><<<grid, kThreads, 0, s>>>(
        shift < 32 ? lo : hi, nullptr, n, block, nb, shift & 31, ranks,
        hist);
  }
  return cudaGetLastError();
}

}  // extern "C"
