// Bitonic sort of power-of-two chunks by the u64 key (hi, lo), carrying up
// to 8 u32 payload planes (B5).
//
// Replaces tpu_qe/kernels/bitonic.py::sort_chunks, whose TPU form runs every
// compare-exchange stage as whole-tile rolls and selects in VMEM. This is
// the same network with the same per-pair rule, so keys and payloads come
// out bit-identical to it, ties included: the pair (a at the lower index,
// b = a's partner at +j) exchanges iff (a > b) differs from "descending",
// where descending = (index in chunk & k) != 0. Equal keys therefore exchange
// in descending regions; a textbook `a > b` swap (or any other sort inside
// the tile) would move tied payloads differently.
//
// By bytes the function reads and writes each plane once (0.12 ms for 2^24
// keys and a payload at an H100's 3.35 TB/s); the network of a chunk of
// 8192 is 91 stages of n / 2 compare-exchanges, a few hundred integer
// instructions an element, which is what bounds it on this card. A network
// that lives in shared memory pays two reads, a write and a block barrier
// per stage on top. So the design keeps the elements in registers:
//
// - A CUDA block of 512 threads sorts a tile of 8192 consecutive elements
//   (whole chunks, or a part of a wider chunk), 16 elements a thread. In
//   the home layout thread t holds elements 16 t .. 16 t + 15: an element's
//   index bits 0-3 choose the register, 4-8 the lane, 9-12 the warp. Loads
//   and stores are 16 bytes a thread in that layout.
// - A stage whose stride lies in the register bits (1, 2, 4, 8) is a
//   compare-exchange of two registers: no memory, no barrier. That covers
//   every stage of the first four merge sizes and the last four of each
//   later one: 46 of 91.
// - A stride in the lane bits (16..256; 35 of 91) is one __shfl_xor_sync
//   per word. The two threads of a pair decide alike from their two
//   sides: the lower tests gt(mine, partner) == up, the upper
//   gt(partner, mine) == up.
// - Strides in the warp bits (512..4096; 10 of 91) wait for a transposition
//   through shared memory that trades the register bits for the warp bits,
//   after which they are register strides too, and one back: four block
//   barriers per merge size of 1024 and up, 16 for a chunk of 8192 in place
//   of 91. Rows are padded by one word in 16 so that both layouts touch 32
//   banks.
// - What is sorted is (lo, hi, index in chunk): three words an element
//   whatever the payload count. Each payload plane then moves once by the
//   final index, out[p][slot] = in[p][index[slot]], a gather inside the
//   chunk (32 KB a plane for a chunk of 8192, which L1 holds). It is the
//   same permutation, so 0..8 planes take one code path at 48 registers of
//   data. Keys alone take an instantiation without the index.
//
// Chunks narrower than a tile share one (the network never crosses a
// chunk, and `up` looks at the index in the chunk only). Chunks wider than
// a tile keep their strides >= 8192 as one global-memory launch each
// (stage_kernel) over lo, hi and an index plane that the caller provides;
// everything inside a tile runs in tile_kernel, whose last launch gathers
// the payloads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPayloads = 8;
constexpr int kThreads = 512;
constexpr int kElems = 16;                 // elements a thread: 4 index bits
constexpr int kRegBits = 4;
constexpr int kLaneBits = 5;
constexpr int kTileBits = 13;
constexpr int kTile = kThreads * kElems;   // 8192
constexpr int kWarpBit0 = kRegBits + kLaneBits;   // index bit 9
constexpr int kPadded = kTile + kTile / 16;       // words a plane, padded
constexpr int kStageThreads = 256;
constexpr uint32_t kFullWarp = 0xFFFFFFFFu;
static_assert(kTile == 1 << kTileBits, "13 index bits");
static_assert(kTileBits - kWarpBit0 == kRegBits,
              "the transposition trades the register bits for the warp bits");

struct Planes {            // stage_kernel: lo, hi and, with payloads, index
  uint32_t* p[3];
};

struct Payloads {
  const uint32_t* in[kMaxPayloads];
  uint32_t* out[kMaxPayloads];
  int count;
};

__device__ __forceinline__ int padded(int i) { return i + (i >> 4); }

// A thread's elements. Without INDEX `ix` is never touched and the
// compiler drops it.
struct Elements {
  uint32_t lo[kElems], hi[kElems], ix[kElems];
};

__device__ __forceinline__ bool key_gt(uint32_t alo, uint32_t ahi,
                                       uint32_t blo, uint32_t bhi) {
  return (static_cast<uint64_t>(ahi) << 32 | alo) >
         (static_cast<uint64_t>(bhi) << 32 | blo);
}

// One stage whose stride is register bit BIT; up(e) is the direction of
// the pair whose lower element is register e.
template <int BIT, bool INDEX, typename Up>
__device__ __forceinline__ void register_stage(Elements& x, Up up) {
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    if (e & (1 << BIT)) continue;
    const int f = e | (1 << BIT);
    if (key_gt(x.lo[e], x.hi[e], x.lo[f], x.hi[f]) == up(e)) {
      uint32_t t = x.lo[e]; x.lo[e] = x.lo[f]; x.lo[f] = t;
      t = x.hi[e]; x.hi[e] = x.hi[f]; x.hi[f] = t;
      if (INDEX) { t = x.ix[e]; x.ix[e] = x.ix[f]; x.ix[f] = t; }
    }
  }
}

// The stages with register strides 2^top .. 1, in that order.
template <bool INDEX, typename Up>
__device__ __forceinline__ void register_stages(Elements& x, int top, Up up) {
  if (top >= 3) register_stage<3, INDEX>(x, up);
  if (top >= 2) register_stage<2, INDEX>(x, up);
  if (top >= 1) register_stage<1, INDEX>(x, up);
  register_stage<0, INDEX>(x, up);
}

// One stage whose partner is the same register of lane ^ lane_bit (home
// layout); `up` is the direction of all of this thread's pairs.
template <bool INDEX>
__device__ __forceinline__ void lane_stage(Elements& x, int lane_bit,
                                           bool up) {
  const bool lower = (threadIdx.x & lane_bit) == 0;
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const uint32_t plo = __shfl_xor_sync(kFullWarp, x.lo[e], lane_bit);
    const uint32_t phi = __shfl_xor_sync(kFullWarp, x.hi[e], lane_bit);
    uint32_t pix = 0u;
    if (INDEX) pix = __shfl_xor_sync(kFullWarp, x.ix[e], lane_bit);
    const bool gt = lower ? key_gt(x.lo[e], x.hi[e], plo, phi)
                          : key_gt(plo, phi, x.lo[e], x.hi[e]);
    if (gt == up) {
      x.lo[e] = plo;
      x.hi[e] = phi;
      if (INDEX) x.ix[e] = pix;
    }
  }
}

// Moves every element between the home layout (register e of thread t is
// tile index 16 t + e) and the transposed one (register e of lane l in warp
// w is 512 e + 16 l + w): written at the one layout's indices, read at the
// other's. Holds two block barriers; the first also ends every earlier use
// of the shared planes.
template <bool INDEX, typename From, typename To>
__device__ __forceinline__ void relayout(Elements& x, uint32_t* shared,
                                         From from, To to) {
  uint32_t* const s_lo = shared;
  uint32_t* const s_hi = shared + kPadded;
  uint32_t* const s_ix = shared + 2 * kPadded;
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const int i = padded(from(e));
    s_lo[i] = x.lo[e];
    s_hi[i] = x.hi[e];
    if (INDEX) s_ix[i] = x.ix[e];
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const int i = padded(to(e));
    x.lo[e] = s_lo[i];
    x.hi[e] = s_hi[i];
    if (INDEX) x.ix[e] = s_ix[i];
  }
}

__device__ __forceinline__ void load16(const uint32_t* src,
                                       uint32_t (&r)[kElems]) {
  const uint4* const v = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int q = 0; q < kElems / 4; ++q) {
    const uint4 w = v[q];
    r[4 * q] = w.x; r[4 * q + 1] = w.y; r[4 * q + 2] = w.z; r[4 * q + 3] = w.w;
  }
}

__device__ __forceinline__ void store16(uint32_t* dst,
                                        const uint32_t (&r)[kElems]) {
  uint4* const v = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int q = 0; q < kElems / 4; ++q) {
    v[q] = make_uint4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
  }
}

// One launch per tile of kTile consecutive elements of the (nb, width)
// planes (total = nb * width elements, a multiple of 16; the planes are
// 16-byte aligned): merge sizes 2^m_lo .. 2^m_hi, each with its strides
// min(2^m, kTile) / 2 .. 1. src_ix null: the index starts as the index in
// the chunk. dst_ix null: the index is not stored. With payloads (the last
// launch of a sort), plane p goes out as in[p][chunk + index]. src and dst
// may be the same planes: a tile is read whole before it is written.
template <bool INDEX>
__global__ void __launch_bounds__(kThreads, 1)
tile_kernel(const uint32_t* src_lo, const uint32_t* src_hi,
            const uint32_t* src_ix, uint32_t* dst_lo, uint32_t* dst_hi,
            uint32_t* dst_ix, Payloads pay, int64_t total, int64_t width,
            int m_lo, int m_hi) {
  extern __shared__ uint32_t shared[];   // 2 or 3 planes of kPadded words
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t g0 = tile0 + tid * kElems;   // this thread's first element
  // A thread's 16 elements lie in one chunk (width >= 16); a tile past the
  // planes' end holds threads with nothing: they sort zeros and store none.
  const bool valid = g0 < total;
  const int64_t chunk0 = g0 & ~(width - 1);
  const auto home = [&](int e) { return tid * kElems + e; };
  const auto transposed = [&](int e) {
    return (e << kWarpBit0) + (lane << kRegBits) + warp;
  };

  Elements x;
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    x.lo[e] = 0u;
    x.hi[e] = 0u;
    x.ix[e] = static_cast<uint32_t>(g0 - chunk0) + e;
  }
  if (valid) {
    load16(src_lo + g0, x.lo);
    load16(src_hi + g0, x.hi);
    if (INDEX && src_ix != nullptr) load16(src_ix + g0, x.ix);
  }

  // Merge sizes 2, 4 and 8 lie in the register bits with their directions
  // (a chunk has at least 16 elements): known at compile time.
  if (m_lo == 1) {
    register_stage<0, INDEX>(x, [](int e) { return (e & 2) == 0; });
    register_stages<INDEX>(x, 1, [](int e) { return (e & 4) == 0; });
    register_stages<INDEX>(x, 2, [](int e) { return (e & 8) == 0; });
    m_lo = 4;
  }
  // From 16 on, a merge's direction is one for all of a thread's elements
  // in the home layout: bit m of the index in the chunk, which lies in the
  // tile index up to m = 12 and in the tile's place in its chunk beyond;
  // the chunk's last merge (2^m = width) is ascending. In the transposed
  // layout register e holds index bits 9-12.
  for (int m = m_lo; m <= m_hi; ++m) {
    const int64_t k = int64_t{1} << m;
    const uint32_t mask =
        (m < kTileBits && k < width) ? static_cast<uint32_t>(k) : 0u;
    const bool flip = m >= kTileBits && k < width && (tile0 & k) != 0;
    const bool up = (((tid * kElems) & mask) == 0u) != flip;
    const int top = m - 1 < kTileBits - 1 ? m - 1 : kTileBits - 1;
    if (top >= kWarpBit0) {
      relayout<INDEX>(x, shared, home, transposed);
      register_stages<INDEX>(x, top - kWarpBit0, [&](int e) {
        return (((e << kWarpBit0) & mask) == 0u) != flip;
      });
      relayout<INDEX>(x, shared, transposed, home);
    }
    for (int s = top < kWarpBit0 - 1 ? top : kWarpBit0 - 1; s >= kRegBits;
         --s) {
      lane_stage<INDEX>(x, 1 << (s - kRegBits), up);
    }
    register_stages<INDEX>(x, kRegBits - 1, [&](int) { return up; });
  }

  if (!valid) return;   // after the last barrier and shuffle
  store16(dst_lo + g0, x.lo);
  store16(dst_hi + g0, x.hi);
  if (INDEX) {
    if (dst_ix != nullptr) store16(dst_ix + g0, x.ix);
    for (int p = 0; p < pay.count; ++p) {
      const uint32_t* __restrict__ in = pay.in[p] + chunk0;
      uint32_t v[kElems];
#pragma unroll
      for (int e = 0; e < kElems; ++e) v[e] = in[x.ix[e]];
      store16(pay.out[p] + g0, v);
    }
  }
}

// Index of the lower element of pair `pair` at stride j: a zero bit
// inserted at bit log2(j).
__device__ __forceinline__ int64_t pair_low(int64_t pair, int64_t j) {
  return ((pair & ~(j - 1)) << 1) | (pair & (j - 1));
}

// One stage (merge size k, stride j >= kTile) over every chunk, in global
// memory.
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

template <bool INDEX>
cudaError_t launch_tile(unsigned tiles, cudaStream_t stream,
                        const uint32_t* src_lo, const uint32_t* src_hi,
                        const uint32_t* src_ix, uint32_t* dst_lo,
                        uint32_t* dst_hi, uint32_t* dst_ix,
                        const Payloads& pay, int64_t total, int64_t width,
                        int m_lo, int m_hi) {
  const size_t bytes = (INDEX ? 3 : 2) * kPadded * sizeof(uint32_t);
  const cudaError_t err = cudaFuncSetAttribute(
      tile_kernel<INDEX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  tile_kernel<INDEX><<<tiles, kThreads, bytes, stream>>>(
      src_lo, src_hi, src_ix, dst_lo, dst_hi, dst_ix, pay, total, width, m_lo,
      m_hi);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements of a chunk of `width` that one launch sorts in registers and
// shared memory: the chunk, or the tile of 8192 if the chunk is wider. The
// plane count and the device do not change it.
int64_t tq_sort_chunks_tile(int64_t width, int np, int device) {
  (void)np;
  (void)device;
  return width < kTile ? width : kTile;
}

// planes_in/planes_out: np (2 + payloads) pointers to (nb, width) u32
// planes, 16-byte aligned, lo and hi first; width a power of two, 16 to
// 2^31. Sorts each chunk of planes_in into planes_out. `index`: a scratch
// plane of the same shape, needed (and touched) only when the chunk is
// wider than the tile and there are payloads. Returns cudaGetLastError.
int tq_sort_chunks(void* const* planes_in, void* const* planes_out, int np,
                   int64_t nb, int64_t width, void* index, int device,
                   void* stream) {
  if (np < 2 || np > 2 + kMaxPayloads || width < kElems ||
      width > (int64_t{1} << 31) || (width & (width - 1)) != 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nb == 0) return cudaSuccess;
  const int64_t total = nb * width;
  const int64_t tiles64 = (total + kTile - 1) / kTile;
  if (tiles64 > 0x7FFFFFFF) return cudaErrorInvalidConfiguration;
  const unsigned tiles = static_cast<unsigned>(tiles64);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  const uint32_t* const src_lo = static_cast<const uint32_t*>(planes_in[0]);
  const uint32_t* const src_hi = static_cast<const uint32_t*>(planes_in[1]);
  uint32_t* const dst_lo = static_cast<uint32_t*>(planes_out[0]);
  uint32_t* const dst_hi = static_cast<uint32_t*>(planes_out[1]);
  uint32_t* const ix = static_cast<uint32_t*>(index);
  Payloads pay{}, none{};
  pay.count = np - 2;
  for (int p = 0; p < pay.count; ++p) {
    pay.in[p] = static_cast<const uint32_t*>(planes_in[2 + p]);
    pay.out[p] = static_cast<uint32_t*>(planes_out[2 + p]);
  }
  int log_width = 0;
  while ((int64_t{1} << log_width) < width) ++log_width;
  const bool indexed = pay.count > 0;

  if (width <= kTile) {
    return indexed ? launch_tile<true>(tiles, st, src_lo, src_hi, nullptr,
                                       dst_lo, dst_hi, nullptr, pay, total,
                                       width, 1, log_width)
                   : launch_tile<false>(tiles, st, src_lo, src_hi, nullptr,
                                        dst_lo, dst_hi, nullptr, none, total,
                                        width, 1, log_width);
  }

  if (indexed && ix == nullptr) return cudaErrorInvalidValue;
  err = indexed ? launch_tile<true>(tiles, st, src_lo, src_hi, nullptr, dst_lo,
                                    dst_hi, ix, none, total, width, 1,
                                    kTileBits)
                : launch_tile<false>(tiles, st, src_lo, src_hi, nullptr,
                                     dst_lo, dst_hi, nullptr, none, total,
                                     width, 1, kTileBits);
  if (err != cudaSuccess) return err;

  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  Planes planes{{dst_lo, dst_hi, ix}};
  const int stage_planes = indexed ? 3 : 2;
  const int64_t pairs = nb * (width / 2);
  const int64_t needed = (pairs + kStageThreads - 1) / kStageThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 16;
  const unsigned grid = static_cast<unsigned>(needed < cap ? needed : cap);
  for (int m = kTileBits + 1; m <= log_width; ++m) {
    const int64_t k = int64_t{1} << m;
    for (int64_t j = k / 2; j >= kTile; j /= 2) {
      stage_kernel<<<grid, kStageThreads, 0, st>>>(
          planes, stage_planes, pairs, log_width - 1, width, k, j);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const bool last = m == log_width;
    err = indexed ? launch_tile<true>(tiles, st, dst_lo, dst_hi, ix, dst_lo,
                                      dst_hi, last ? nullptr : ix,
                                      last ? pay : none, total, width, m, m)
                  : launch_tile<false>(tiles, st, dst_lo, dst_hi, nullptr,
                                       dst_lo, dst_hi, nullptr, none, total,
                                       width, m, m);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // extern "C"
