// Flat exclusive prefix sum of u32, wrapping mod 2^32 (B2).
//
// Replaces tpu_qe/kernels/scan.py::exclusive_scan. The TPU kernel is one
// pass that carries the running total in SMEM from one grid step to the
// next; Hopper blocks run in no order, so the carry becomes a chain of
// published words: a single-pass scan with decoupled look-back (Merrill and
// Garland). One launch, every input word read once and every output word
// written once: 8 bytes of HBM traffic a word.
//
// What bounds it on an H100. A radix pass scans its (radix, nb) table: 2^17
// to 2^22 words, at most 32 MB in and out, which the 50 MB L2 holds, so the
// time there is the launch and the chain of dependent round trips inside a
// block (ticket, loads, look-back, stores), not bytes; at 2^24 words and
// above it is the 8 bytes a word at the HBM rate. So the design keeps the
// chain short and the traffic at its least:
// - A block takes a tile of kTile words. Its index is a ticket from a
//   global atomic, not blockIdx.x, so every predecessor of a tile has
//   started before it and a block that waits for one cannot starve it.
// - Warp w owns the tile's w-th run of 32 * kItems words and lane l loads
//   the uint4 at 16-byte slots l, 32 + l, ... of it: every load is one
//   coalesced 512-byte row, kVecs of them in flight per thread. The scan
//   runs in registers: serial inside a uint4, one shuffle scan per row (the
//   kVecs rows interleaved), then the rows' totals in order. Only the warp
//   totals pass through shared memory: one barrier.
// - The tile publishes (status, value) as one 64-bit word with one store,
//   so no reader sees a flag without its value: first its aggregate, then,
//   after warp 0 has looked back over its predecessors 32 at a time (one
//   ballot on the status), its inclusive prefix. A second barrier hands
//   the tile's exclusive prefix to the other warps.
// - The status words live in scratch that the caller allocates without
//   clearing, so tq_exclusive_scan clears them on the stream first
//   (cudaMemsetAsync: tiles * 8 + 8 bytes). A table of one tile takes no
//   ticket, no status and no memset.
// - Any n and any alignment: the last tile masks (g < n), and a pointer
//   that is not 16-byte aligned (a slice of a larger tensor) takes the
//   instantiation with 4-byte loads and stores in the same layout.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 8;                      // uint4 rows per thread
constexpr int kItems = 4 * kVecs;             // words per thread
constexpr int kWarpSpan = 32 * kItems;        // words per warp
constexpr int64_t kTile = int64_t{kThreads} * kItems;
constexpr uint32_t kFull = 0xFFFFFFFFu;

// Status of a tile's published word (its upper half); the memset leaves 0.
constexpr uint64_t kInvalid = 0, kAggregate = 1, kPrefix = 2;

__device__ __forceinline__ uint64_t load_word(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_word(uint64_t* p, uint64_t status,
                                           uint32_t value) {
  const uint64_t v = (status << 32) | value;
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" : : "l"(p), "l"(v) : "memory");
}

// The sum of the aggregates of tiles first, first - 1, ... down to the
// nearest one that has published its inclusive prefix, that prefix
// included. Called by one whole warp; every lane returns the sum.
__device__ __forceinline__ uint32_t look_back(const uint64_t* status,
                                              int64_t first, int lane) {
  uint32_t sum = 0u;
  for (;; first -= 32) {
    const int64_t i = first - lane;
    uint64_t word;
    do {   // before tile 0 lies an inclusive prefix of 0
      word = i >= 0 ? load_word(status + i) : kPrefix << 32;
    } while (__any_sync(kFull, (word >> 32) == kInvalid));
    const uint32_t done = __ballot_sync(kFull, (word >> 32) == kPrefix);
    uint32_t v = static_cast<uint32_t>(word);
    if (done && lane >= __ffs(done)) v = 0u;   // beyond the nearest prefix
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    sum += v;
    if (done) return sum;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
            uint64_t* __restrict__ status, uint32_t* __restrict__ ticket,
            int64_t n) {
  __shared__ uint32_t warp_totals[kWarps];
  __shared__ uint32_t shared_tile, shared_prefix;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool chained = gridDim.x > 1;   // one tile: nothing to chain

  int64_t tile = 0;
  if (chained) {
    if (tid == 0) shared_tile = atomicAdd(ticket, 1u);
    __syncthreads();
    tile = shared_tile;
  }
  const int64_t w0 = tile * kTile + warp * kWarpSpan;
  const bool full = (tile + 1) * kTile <= n;

  // v[k][i]: word 4 * (32 k + lane) + i of the warp's run.
  uint32_t v[kVecs][4];
  if (VEC && full) {
    const uint4* __restrict__ src = reinterpret_cast<const uint4*>(x + w0);
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const uint4 q = src[32 * k + lane];
      v[k][0] = q.x; v[k][1] = q.y; v[k][2] = q.z; v[k][3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t g = w0 + 4 * (32 * k + lane) + i;
        v[k][i] = g < n ? x[g] : 0u;
      }
    }
  }

  // Inclusive inside each uint4, then each row across the lanes; e[k] is
  // the exclusive prefix of the thread's k-th uint4 inside the warp's run.
  uint32_t s[kVecs], e[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    v[k][1] += v[k][0];
    v[k][2] += v[k][1];
    v[k][3] += v[k][2];
    s[k] = v[k][3];
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const uint32_t up = __shfl_up_sync(kFull, s[k], o);
      if (lane >= o) s[k] += up;
    }
  }
  uint32_t warp_total = 0u;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    e[k] = warp_total + s[k] - v[k][3];
    warp_total += __shfl_sync(kFull, s[k], 31);
  }
  if (lane == 0) warp_totals[warp] = warp_total;
  __syncthreads();
  uint32_t before = 0u, aggregate = 0u;   // earlier warps; the whole tile
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t t = warp_totals[w];
    if (w < warp) before += t;
    aggregate += t;
  }

  if (chained) {
    if (warp == 0) {
      uint32_t prefix = 0u;
      if (tile > 0) {
        if (lane == 0) store_word(status + tile, kAggregate, aggregate);
        prefix = look_back(status, tile - 1, lane);
      }
      if (lane == 0) {
        store_word(status + tile, kPrefix, prefix + aggregate);
        shared_prefix = prefix;
      }
    }
    __syncthreads();
    before += shared_prefix;
  }

  if (VEC && full) {
    uint4* __restrict__ dst = reinterpret_cast<uint4*>(out + w0);
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const uint32_t b = before + e[k];
      dst[32 * k + lane] =
          make_uint4(b, b + v[k][0], b + v[k][1], b + v[k][2]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const uint32_t b = before + e[k];
      const uint32_t o[4] = {b, b + v[k][0], b + v[k][1], b + v[k][2]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t g = w0 + 4 * (32 * k + lane) + i;
        if (g < n) out[g] = o[i];
      }
    }
  }
}

__global__ void empty_kernel() {}

inline int64_t num_tiles(int64_t n) { return (n + kTile - 1) / kTile; }

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// Number of u32 words of scratch that tq_exclusive_scan needs for n: one
// 64-bit status word per tile and the ticket.
int64_t tq_exclusive_scan_scratch(int64_t n) { return 2 * num_tiles(n) + 2; }

// out[i] = x[0] + ... + x[i-1] mod 2^32. scratch holds
// tq_exclusive_scan_scratch(n) words at an 8-byte aligned address; its
// contents do not matter. Returns the first error.
int tq_exclusive_scan(const uint32_t* x, uint32_t* out, uint32_t* scratch,
                      int64_t n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int64_t tiles = num_tiles(n);
  if (tiles == 0) return cudaSuccess;
  if (tiles > 0x7FFFFFFF || (reinterpret_cast<uintptr_t>(scratch) & 7u)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint64_t* status = reinterpret_cast<uint64_t*>(scratch);
  uint32_t* ticket = scratch + 2 * tiles;
  if (tiles > 1) {
    err = cudaMemsetAsync(scratch, 0, (2 * tiles + 2) * sizeof(uint32_t), s);
    if (err != cudaSuccess) return err;
  }
  const auto kernel = aligned16(x) && aligned16(out) ? scan_kernel<true>
                                                     : scan_kernel<false>;
  kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(x, out, status,
                                                           ticket, n);
  return cudaGetLastError();
}

// One launch of a kernel that does nothing: the least any launch costs on
// this stream, for the bound of a kernel whose bytes take less than that.
int tq_empty_launch(int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

}  // extern "C"
