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
// 8 + 4 * payloads bytes per key, plus its radix * nb base words: 406.8 MB
// at 2^24 keys, block 4096, an 8-bit digit and one payload, 0.121 ms at an
// H100's 3.35 TB/s. The arithmetic per key is a handful of integer ops.
// The design keeps every per-digit counter in shared memory (the
// digit-major histogram is the only counter traffic to HBM, radix * nb
// words), reads keys with consecutive threads on consecutive addresses,
// and needs no global atomics. B3 holds 16 keys per thread so that many
// loads are in flight and a 4096-key tile costs one ranking round and a
// handful of barriers, and its scatter stages each tile in digit order
// through shared memory, so that a warp stores whole runs of equal digits
// to consecutive addresses (see the note at rank_kernel).
//
// A ragged tail is masked (g < n), never padded: the result equals the
// sentinel-padded JAX pipeline because all-ones sentinels take the largest
// digit and sit after every real key of the last block.
//
// Digits of 1..8 bits take the kernels above the "wide digits" line; 9..16
// bits (as the JAX kernels and SortConfig allow) take the wide kernels,
// whose per-digit counters do not fit the 8-bit path's static tables. B1
// and B3's rank mode keep u16 counters, two to a word, in dynamic shared
// memory (up to 128 KB at 16 bits); a block then holds at most 65535 keys,
// so no counter carries into its neighbour. There the dense (radix, nb)
// table outweighs the keys (1.07 GB against 67 MB at 16 bits and 2^24
// keys), so wide B1 is bound by how it writes the table: whole sectors from
// groups of eight key blocks (see the note at histogram_group_kernel). B3's
// wide scatter, which every sort with wide digits runs once per pass, keeps
// no table for a block of one tile: it sorts the tile by the digit in
// shared memory, so that a key's cost does not grow with the radix, reads
// one base word per run of equal digits, and stores in digit order. The
// sectors its short runs touch bound it, not its bytes (see the note at
// scatter_wide_kernel).

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
// and the wide kernels use it.
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

// B3 for 1..8-bit digits: one CUDA block per key block, walked in tiles of
// kTile = kThreads * kKeys keys (one tile for the default 4096-key block).
//
// Keys sit in registers warp-striped: warp w owns the tile's w-th run of
// 32 * kKeys keys and lane l holds keys 32 j + l of it, j = 0..kKeys-1. So
// every load is one coalesced 128-byte row per warp, kKeys of them are in
// flight per thread, and inside a warp (j, lane) order is input order. The
// rank of a key among equal digits of its block, in input order, is then
//   popc(match_digit(digit) & lanemask_lt)    (earlier lanes, round j)
//   + the warp's count of the digit before round j (a warp-private
//     counter row in shared memory: the first lane of each match group
//     adds the group's size, no atomics, __syncwarp between rounds)
//   + the digit's count in earlier warps of the tile (one scan per tile)
//   + its running count in earlier tiles (a register of thread `digit`).
//
// Rank mode writes that rank at the key's own index (coalesced) and the
// block's histogram at the end. Scatter mode turns it into a slot of the
// tile in digit order (an exclusive scan of the tile's digit totals gives
// each digit's first slot), writes the key words to shared memory at their
// slot, and then thread i stores slots i, i + 256, ... to
//   run_base[digit] + slot,
//   run_base[d] = base[d * nb + b] + running[d] - first slot of d,
// so neighbouring lanes write neighbouring addresses inside a run of equal
// digits: 16 keys (64 B per plane) on average with uniform 8-bit digits,
// hundreds with the operators' 1- and 2-bit passes. Payloads follow plane
// by plane through the same two staging planes in turn; a thread keeps
// only its keys' slots and its slots' destinations.
//
// Sizes on an H100 (227 KB shared memory per block, 65,536 registers and
// 2048 threads per SM): kKeys = 16 needs 2 * 16 KB of staging + 8 KB of
// warp counters + 1 KB of run bases, 42 KB in all, and at most 85 registers
// a thread for three blocks per SM (__launch_bounds__), i.e. 24 warps and
// 12,288 keys in flight on an SM; shared memory would allow five. A smaller
// kKeys halves the runs and doubles the scans per key; a larger one needs
// more registers than three blocks leave. Loads are 4-byte words: a
// 16-byte load would give a lane four neighbouring keys and break the
// (j, lane) input order that the stable rank rests on.
constexpr int kKeys = 16;                 // keys per thread and tile
constexpr int kTile = kThreads * kKeys;   // 4096
constexpr uint32_t kFullWarp = 0xFFFFFFFFu;
static_assert(kThreads == kMaxRadix, "thread d owns digit d");

// The lanes of the warp whose key is valid and has this lane's digit: one
// ballot per digit bit. (match.any gives the same mask in one instruction,
// but on an H100 its time grows with the number of distinct values in the
// warp, about 30 with random 8-bit digits, and it then bounds the kernel.)
__device__ __forceinline__ uint32_t match_digit(uint32_t d, bool valid,
                                                int bits) {
  uint32_t peers = __ballot_sync(kFullWarp, valid);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k < bits) {   // the same for every thread
      const bool bit = (d >> k) & 1u;
      const uint32_t set = __ballot_sync(kFullWarp, bit);
      peers &= bit ? set : ~set;
    }
  }
  return peers;   // of an invalid lane: unused
}

// The ranking rounds of a tile held warp-striped, kKeys elements a thread:
// element j of this lane is at position 32 * kKeys * warp + 32 j + lane of
// the tile's sequence, valid iff 32 j < lane_keys, and digit(j) is its
// digit of `bits` (1..8) bits; digit(j) of an invalid element may be
// anything. On return r[j] counts the equal digits at earlier positions of
// the warp, and `mine`, the warp's counter row, holds the warp's count of
// every digit.
template <typename Digit>
__device__ __forceinline__ void warp_rank_rounds(Digit digit, int bits,
                                                 int warp_keys, int lane_keys,
                                                 uint32_t* mine,
                                                 uint32_t (&r)[kKeys]) {
  const int lane = threadIdx.x & 31;
  const uint32_t lanemask_lt = (1u << lane) - 1u;
  for (int d = lane; d < (1 << bits); d += 32) mine[d] = 0u;
  __syncwarp();
  // One round per j, in sequence order.
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    r[j] = 0u;
    if (32 * j < warp_keys) {   // the same for the whole warp
      const bool valid = 32 * j < lane_keys;
      const uint32_t d = digit(j);   // of an invalid element: unused
      const uint32_t peers = match_digit(d, valid, bits);
      const uint32_t earlier = __popc(peers & lanemask_lt);
      uint32_t before = 0u;
      if (valid && earlier == 0u) {   // first lane of its match group
        before = mine[d];
        mine[d] = before + __popc(peers);
      }
      before = __shfl_sync(kFullWarp, before, valid ? __ffs(peers) - 1 : 0);
      r[j] = before + earlier;
      __syncwarp();
    }
  }
}

// Slots of a stable sort of such a tile by that digit: on return r[j] is
// the element's slot and, for thread d < 2^bits, `total` the tile's count
// of digit d and `first` its first slot. Every thread of the block calls
// it; it holds barriers, and the last of them follows every use of the
// arguments' shared memory by an earlier call.
template <typename Digit>
__device__ __forceinline__ void tile_sort_slots(
    Digit digit, int bits, int warp_keys, int lane_keys,
    uint32_t (*warp_counts)[kMaxRadix], uint32_t* warp_sums,
    uint32_t (&r)[kKeys], uint32_t& total, uint32_t& first) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int radix = 1 << bits;
  uint32_t* const mine = warp_counts[warp];
  warp_rank_rounds(digit, bits, warp_keys, lane_keys, mine, r);
  __syncthreads();

  // Digit totals of the tile, their exclusive scan over the digits (each
  // digit's first slot), then each warp's first slot per digit.
  total = 0u;
  if (tid < radix) {
    for (int w = 0; w < kWarps; ++w) total += warp_counts[w][tid];
  }
  uint32_t incl = total;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t up = __shfl_up_sync(kFullWarp, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  first = incl - total;
  for (int w = 0; w < warp; ++w) first += warp_sums[w];
  if (tid < radix) {
    uint32_t s = first;
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = warp_counts[w][tid];
      warp_counts[w][tid] = s;
      s += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    if (32 * j < lane_keys) r[j] += mine[digit(j)];
  }
  __syncwarp();   // the next call zeroes this warp's row
}

// B3 for 1..8-bit digits: the note above kKeys.
template <bool SCATTER>
__global__ void __launch_bounds__(kThreads, 3)
rank_kernel(const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
            int64_t n, int64_t block, int64_t nb, int shift, int bits,
            const uint32_t* __restrict__ base, uint32_t* __restrict__ ranks,
            uint32_t* __restrict__ hist, uint32_t* __restrict__ out_lo,
            uint32_t* __restrict__ out_hi, Planes planes) {
  extern __shared__ uint32_t stage[];  // SCATTER: two planes of kTile words
  __shared__ uint32_t warp_counts[kWarps][kMaxRadix];
  __shared__ uint32_t run_base[kMaxRadix];
  __shared__ uint32_t warp_sums[kWarps];
  const int radix = 1 << bits;
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  uint32_t* const mine = warp_counts[warp];
  uint32_t* const stage_a = stage;
  uint32_t* const stage_b = stage + kTile;

  // Thread d keeps digit d's running in-block count and, for the scatter,
  // its (digit, block) base from B2's scan.
  uint32_t running = 0u, digit_base = 0u;
  if (SCATTER && tid < radix) digit_base = base[tid * nb + b];

  const int64_t start = b * block;
  const int64_t end = start + block < n ? start + block : n;
  for (int64_t t0 = start; t0 < end; t0 += kTile) {
    const int tile_keys = end - t0 < kTile ? static_cast<int>(end - t0) : kTile;
    // Key j of this lane is valid iff 32 j < lane_keys (a ragged tail ends
    // the tile in input order, so validity is a prefix of every lane).
    const int warp_keys = tile_keys - warp * 32 * kKeys;
    const int lane_keys = warp_keys - lane;
    const int64_t g0 = t0 + warp * 32 * kKeys + lane;

    // Scatter mode holds both words; rank mode holds the digit in w0.
    uint32_t w0[kKeys], w1[kKeys], r[kKeys];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      w0[j] = 0u;
      w1[j] = 0u;
      if (32 * j < lane_keys) {
        if (SCATTER) {
          w0[j] = lo[g0 + 32 * j];
          w1[j] = hi[g0 + 32 * j];
        } else {
          w0[j] = load_digit(lo, hi, g0 + 32 * j, shift, bits);
        }
      }
    }
    const auto digit = [&](int j) {
      return SCATTER ? select_digit(w0[j], w1[j], shift, bits) : w0[j];
    };
    if (SCATTER) {
      uint32_t total, first;
      tile_sort_slots(digit, bits, warp_keys, lane_keys, warp_counts,
                      warp_sums, r, total, first);
      if (tid < radix) {
        run_base[tid] = digit_base + running - first;
        running += total;
      }
      // Stage the key words at their slots.
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        if (32 * j < lane_keys) {
          stage_a[r[j]] = w0[j];
          stage_b[r[j]] = w1[j];
        }
      }
      __syncthreads();

      // Store runs: slot i goes to run_base[its digit] + i; w0 becomes the
      // slot's destination.
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int i = tid + kThreads * j;
        if (i < tile_keys) {
          const uint32_t l = stage_a[i];
          const uint32_t h = stage_b[i];
          w0[j] = run_base[select_digit(l, h, shift, bits)] + i;
          out_lo[w0[j]] = l;
          out_hi[w0[j]] = h;
        }
      }

      // Payload planes, one at a time, through the staging planes in turn:
      // a plane is written only after a barrier that follows its last
      // read. A plane's words go from their load straight to their slots
      // (holding the next plane's loads in registers across the barrier
      // was 7 % slower on an H100).
      if (planes.count > 0) __syncthreads();
      for (int p = 0; p < planes.count; ++p) {
        const uint32_t* __restrict__ in = planes.in[p];
        uint32_t* __restrict__ out = planes.out[p];
        uint32_t* const buf = (p & 1) ? stage_b : stage_a;
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          if (32 * j < lane_keys) buf[r[j]] = in[g0 + 32 * j];
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          const int i = tid + kThreads * j;
          if (i < tile_keys) out[w0[j]] = buf[i];
        }
      }
    } else {
      warp_rank_rounds(digit, bits, warp_keys, lane_keys, mine, r);
      __syncthreads();
      // Each warp's count of the digit so far in the block.
      if (tid < radix) {
        uint32_t s = running;
        for (int w = 0; w < kWarps; ++w) {
          const uint32_t c = warp_counts[w][tid];
          warp_counts[w][tid] = s;
          s += c;
        }
        running = s;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        if (32 * j < lane_keys) ranks[g0 + 32 * j] = mine[w0[j]] + r[j];
      }
      __syncwarp();   // the next tile zeroes this warp's row
    }
  }
  if (!SCATTER && tid < radix) hist[tid * nb + b] = running;
}

constexpr size_t kStageBytes = 2 * kTile * sizeof(uint32_t);

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

// Take digit d's u16 counter out of the table: returns it and leaves zero.
// Of several threads that ask for one digit, one gets the count and the
// others zero, so the table cleans itself where it was touched.
__device__ __forceinline__ uint32_t take_u16(uint32_t* words, uint32_t d) {
  const uint32_t sh = (d & 1u) * 16u;
  return (atomicAnd(&words[d >> 1], ~(0xFFFFu << sh)) >> sh) & 0xFFFFu;
}

// The histogram store of a kernel that keeps one table of u16 counters per
// key block, for digits so wide that nearly every counter is zero: the
// (radix, nb) table in global memory was cleared before the launch, and
// only the non-zero counters are stored, by a second walk over the block's
// keys (they come from L1 or L2 now). Each key's thread takes its digit's
// counter; the one that finds a count stores it. That is at most one
// 4-byte store per key, where a store of every counter is radix stores per
// block, each at a stride of nb words. Every thread of the CUDA block calls
// it after a barrier that follows the last increment.
template <typename Digit>
__device__ __forceinline__ void store_counts(Digit digit, int64_t start,
                                             int64_t end, uint32_t* words,
                                             int64_t nb, int64_t b,
                                             uint32_t* __restrict__ hist) {
#pragma unroll 4
  for (int64_t g = start + threadIdx.x; g < end; g += blockDim.x) {
    const uint32_t d = digit(g);
    const uint32_t c = take_u16(words, d);
    if (c != 0u) hist[d * nb + b] = c;
  }
}

// B1 for 9..16-bit digits. What bounds it on an H100 is the dense
// (radix, nb) table, not the keys: 34 MB at 11 bits and 1.07 GB at 16 for
// the 67 MB of key words of 2^24 keys in blocks of 4096, and all but 4096
// of a block's counters are zero. A kernel that stores every counter of its
// key block does radix 4-byte stores at a stride of nb words, each into a
// 32-byte sector that seven other CUDA blocks write too; storing only the
// non-zero counters into a cleared table is still one scattered sector
// write per key, which the card does at some 15 G a second. So the table
// is written in whole sectors, once, and nothing else:
//
// A work item is a group of kGroup = 8 consecutive key blocks and a window
// of 2^kWindowBits digits. Its CUDA block reads the group's keys, counts
// those whose digit falls into the window into u16 counters laid out
// [pair of key blocks][digit], so that the increments of one key block fall
// on banks chosen by the digit, and then stores, per digit, the eight
// counts as four 8-byte words side by side: hist[d * nb + b0 .. b0 + 7] is
// one whole 32-byte sector where nb is a multiple of 8. The store puts the
// counters back to zero, and a CUDA block walks over several items when
// there are more than the card holds blocks. Rows are padded by 8 words so
// that the 32 lanes of the store (8 digits x 4 pairs) read 32 banks. Up to
// 12 bits one window covers the digit; a 16-bit digit has 16, so every key
// is read 16 times, but the windows of a group are neighbouring items, run
// at the same time, and all but the first find the keys in L2; so are the
// four groups whose sectors make up one 128-byte line of a digit's row. LO
// and HI are fixed at compile time as in histogram_kernel.
//
// On an H100 at 2^24 keys and block 4096 the 1.07 GB table of a 16-bit
// digit takes 0.6 ms to store this way (0.32 by its bytes: the sectors of a
// warp's store lie 16 KB apart), and the 16 reads of the keys 0.3 ms
// before it; at 11 bits the kernel is at 0.6 of its byte bound. Groups of
// 16 key blocks with half the window, or of 4 with twice, were slower.
constexpr int kGroup = 8;                 // key blocks per group
constexpr int kPairs = kGroup / 2;         // two u16 counters to a word
constexpr int kGroupPad = 32 / kPairs;    // words between the group's rows
constexpr int kWindowBits = 12;           // 4 rows of 2^12 words: 64 KB
constexpr int kNearBits = 2;              // groups that run side by side
constexpr int kGroupThreads = 256;

template <bool LO, bool HI>
__global__ void __launch_bounds__(kGroupThreads)
histogram_group_kernel(const uint32_t* __restrict__ lo,
                       const uint32_t* __restrict__ hi, int64_t n,
                       int64_t block, int64_t nb, int shift, int bits,
                       int64_t items, bool pairs,
                       uint32_t* __restrict__ hist) {
  extern __shared__ uint32_t words[];   // [kPairs][span + kGroupPad]
  const int window_bits = bits < kWindowBits ? bits : kWindowBits;
  const int windows_log = bits - window_bits;
  const uint32_t span = 1u << window_bits;
  const int row = span + kGroupPad;
  const int tid = threadIdx.x;
  for (int w = tid; w < kPairs * row; w += kGroupThreads) words[w] = 0u;
  __syncthreads();
  // Items in the order (far, window, near) of a group far * 2^kNearBits +
  // near: the CUDA blocks that run at the same time share their keys, and
  // those of one window write neighbouring sectors. The last `far` may
  // name groups past the end.
  const int64_t groups = (nb + kGroup - 1) / kGroup;
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const int64_t grp = (item >> (windows_log + kNearBits) << kNearBits) |
                        (item & ((1 << kNearBits) - 1));
    if (grp >= groups) continue;   // the same for the whole CUDA block
    const int64_t b0 = grp * kGroup;
    const uint32_t d0 = (static_cast<uint32_t>(item >> kNearBits) &
                         ((1u << windows_log) - 1u)) << window_bits;
    for (int s = 0; s < kGroup && b0 + s < nb; ++s) {
      uint32_t* const counts = words + (s >> 1) * row;
      const uint32_t one = 1u << ((s & 1) * 16);
      const int64_t start = (b0 + s) * block;
      const int64_t end = start + block < n ? start + block : n;
#pragma unroll 8
      for (int64_t g = start + tid; g < end; g += kGroupThreads) {
        const uint32_t d = select_digit(LO ? lo[g] : 0u, HI ? hi[g] : 0u,
                                        shift, bits) - d0;
        if (d < span) atomicAdd(&counts[d], one);
      }
    }
    __syncthreads();
    // Entry i is (digit d0 + i / kPairs, pair i % kPairs): the counts of
    // key blocks b0 + 2 pair and b0 + 2 pair + 1, one shared-memory word.
    for (uint32_t i = tid; i < kPairs * span; i += kGroupThreads) {
      const uint32_t pair = i % kPairs;
      const uint32_t d = i / kPairs;
      const uint32_t w = words[pair * row + d];
      words[pair * row + d] = 0u;
      const int64_t b = b0 + 2 * pair;
      uint32_t* const out = hist + ((d0 + d) * nb + b);
      if (pairs && b + 1 < nb) {   // nb is even and hist 8-byte aligned
        *reinterpret_cast<uint2*>(out) = make_uint2(w & 0xFFFFu, w >> 16);
      } else {
        if (b < nb) out[0] = w & 0xFFFFu;
        if (b + 1 < nb) out[1] = w >> 16;
      }
    }
    __syncthreads();
  }
}

// B3's rank mode for 9..16-bit digits, one key per thread and tile (on no
// sort path; the scatter below is the kernel the sorts run). The in-warp
// rank comes from match_any; the warps of a tile then take turns, in warp
// order, against one table of running in-block counts: warp w reads each
// key's count, then one leader per match group adds the group's size, and a
// barrier passes the turn on. So the rank is the key's occurrence index
// among equal digits of its block in input order. Above kSparseBits bits,
// where a block of 4096 keys leaves most counters zero, the histogram goes
// out as its non-zero counters only, into a cleared table (store_counts).
constexpr int kSparseBits = 12;
__global__ void __launch_bounds__(kThreads)
rank_wide_kernel(const uint32_t* __restrict__ lo,
                 const uint32_t* __restrict__ hi, int64_t n, int64_t block,
                 int64_t nb, int shift, int bits,
                 uint32_t* __restrict__ ranks, uint32_t* __restrict__ hist) {
  extern __shared__ uint32_t words[];
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint32_t lanemask_lt = (1u << lane) - 1u;

  for (int w = tid; w < (1 << bits) / 2; w += kThreads) words[w] = 0u;
  __syncthreads();
  const int64_t start = b * block;
  const int64_t end = start + block < n ? start + block : n;
  for (int64_t t0 = start; t0 < end; t0 += kThreads) {
    const int64_t g = t0 + tid;
    const bool valid = g < end;
    // invalid lanes never match
    const uint32_t d =
        valid ? load_digit(lo, hi, g, shift, bits) : 0xFFFFFFFFu;
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
    if (valid) ranks[g] = r;
  }
  // The last turn ended in a barrier.
  if (bits > kSparseBits) {   // into the table that the entry point cleared
    store_counts([&](int64_t g) { return load_digit(lo, hi, g, shift, bits); },
                 start, end, words, nb, b, hist);
  } else {
    for (int d = tid; d < (1 << bits); d += kThreads) {
      hist[d * nb + b] = get_u16(words, d);
    }
  }
}

// B3's scatter for 9..16-bit digits. A table of `radix` counters per block
// would be mostly empty here (2048 to 65536 digits for the 4096 keys of a
// tile) and its size, its clearing and its turns would grow with the radix.
// So the tile is sorted instead, and the cost of a key does not depend on
// `bits`:
//
// 1. Keys are loaded as in rank_kernel: 16 a thread, warp-striped.
// 2. The tile is sorted stably by the digit as two stable sub-passes of
//    (bits + 1) / 2 and bits / 2 bits, low sub-digit first, each the
//    ranking rounds of rank_kernel (ballot matching, warp-private counter
//    rows, one scan per tile: tile_sort_slots). What moves through shared
//    memory between them is one word a key: its digit and its 12-bit index
//    in the tile. The second sub-pass leaves each key's final slot at its
//    index, the thread that loaded a key reads it back and writes the key's
//    words, still in its registers, to the staging planes at that slot.
//    The tile then lies in (digit, input order) order.
// 3. Thread i takes slots i, i + 256, ...: a slot is a run's head if its
//    digit differs from the slot before, one ballot per 32 slots finds each
//    slot's nearest head, and a running maximum over the 128 groups of 32
//    carries heads across groups. A key's rank among equal digits of the
//    tile is its slot minus its run's head.
// 4. Only the last slot of a run reads base[d * nb + b] from global memory,
//    and, where a block holds several tiles, adds the run's length to the
//    digit's u16 counter of earlier tiles (one shared-memory atomic per run,
//    no turns). It leaves base + earlier count at the head's slot for the
//    run's members. A block of one tile (every engine path: block 4096)
//    takes the instantiation with no table, whose shared memory (57 KB) and
//    blocks per SM do not depend on `bits`; the table is cleared once per
//    CUDA block, which then ranks at least two tiles with it.
// 5. Keys, then each payload plane staged as in rank_kernel, are stored in
//    slot order to run base + rank in run: neighbouring lanes write rising
//    addresses, and the members of a run neighbouring words.
//
// What bounds it on an H100: at the default block a run holds 2 keys on
// average at 11 bits and 1 at 16, so nearly every 4-byte store touches a
// 32-byte sector of its own. The sector count, not the byte count, is the
// bound: 3 planes x 2^24 keys x 32 B is 1.6 GB, 0.48 ms at 3.35 TB/s,
// against 0.12 ms for the bytes. Larger blocks lengthen the runs (16 keys
// at 11 bits and block 32768).
constexpr uint32_t kNoHead = 0xFFFFFFFFu;
constexpr int kGroups = kTile / 32;       // groups of 32 slots per tile
constexpr int kIndexBits = 12;            // a key's index in its tile
static_assert(kTile == 1 << kIndexBits, "the index rides with the digit");
static_assert(kGroups == 4 * 32, "warp 0 scans four groups a lane");

__device__ __forceinline__ uint32_t fetch_add_u16(uint32_t* words, uint32_t d,
                                                  uint32_t v) {
  const uint32_t sh = (d & 1u) * 16u;
  return (atomicAdd(&words[d >> 1], v << sh) >> sh) & 0xFFFFu;
}

template <bool ONE_TILE>
__global__ void __launch_bounds__(kThreads, 3)
scatter_wide_kernel(const uint32_t* __restrict__ lo,
                    const uint32_t* __restrict__ hi, int64_t n, int64_t block,
                    int64_t nb, int shift, int bits,
                    const uint32_t* __restrict__ base,
                    uint32_t* __restrict__ out_lo,
                    uint32_t* __restrict__ out_hi, Planes planes) {
  // Three planes of kTile words; then, unless ONE_TILE, radix u16 counters.
  extern __shared__ uint32_t stage[];
  __shared__ uint32_t warp_counts[kWarps][kMaxRadix];
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ uint32_t group_head[kGroups];
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint32_t lanemask_le = 0xFFFFFFFFu >> (31 - lane);
  uint32_t* const stage_a = stage;
  uint32_t* const stage_b = stage + kTile;
  uint32_t* const stage_c = stage + 2 * kTile;
  uint32_t* const table = stage + 3 * kTile;
  const int low_bits = (bits + 1) / 2;
  const int high_bits = bits - low_bits;
  const uint32_t low_mask = (1u << low_bits) - 1u;

  if (!ONE_TILE) {   // first used after the barriers of the first sort
    for (int w = tid; w < (1 << bits) / 2; w += kThreads) table[w] = 0u;
  }
  const int64_t start = b * block;
  const int64_t end = start + block < n ? start + block : n;
  for (int64_t t0 = start; t0 < end; t0 += kTile) {
    const int tile_keys = end - t0 < kTile ? static_cast<int>(end - t0) : kTile;
    const int warp_keys = tile_keys - warp * 32 * kKeys;
    const int lane_keys = warp_keys - lane;
    const int first_index = warp * 32 * kKeys + lane;
    const int64_t g0 = t0 + first_index;

    uint32_t w0[kKeys], w1[kKeys], r[kKeys], m[kKeys];
    uint32_t total, first;   // of the sorts' sub-digits: unused
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      w0[j] = 0u;
      w1[j] = 0u;
      if (32 * j < lane_keys) {
        w0[j] = lo[g0 + 32 * j];
        w1[j] = hi[g0 + 32 * j];
      }
    }

    // Low sub-digit; then (digit, index) moves to its slot.
    tile_sort_slots(
        [&](int j) {
          return select_digit(w0[j], w1[j], shift, bits) & low_mask;
        },
        low_bits, warp_keys, lane_keys, warp_counts, warp_sums, r, total,
        first);
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      if (32 * j < lane_keys) {
        stage_c[r[j]] = (select_digit(w0[j], w1[j], shift, bits) << kIndexBits)
                        | static_cast<uint32_t>(first_index + 32 * j);
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      m[j] = 32 * j < lane_keys ? stage_c[first_index + 32 * j] : 0u;
    }

    // High sub-digit; the final slot goes to the key's index. Every read
    // of stage_c above precedes the barriers inside the sort.
    const int high_shift = kIndexBits + low_bits;
    tile_sort_slots([&](int j) { return m[j] >> high_shift; }, high_bits,
                    warp_keys, lane_keys, warp_counts, warp_sums, r, total,
                    first);
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      if (32 * j < lane_keys) stage_c[m[j] & (kTile - 1)] = r[j];
    }
    __syncthreads();
    // r becomes the final slot of the key this thread loaded.
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      if (32 * j < lane_keys) {
        r[j] = stage_c[first_index + 32 * j];
        stage_a[r[j]] = w0[j];
        stage_b[r[j]] = w1[j];
      }
    }
    __syncthreads();

    // Heads of the runs of equal digits: m becomes each slot's nearest head
    // inside its group of 32 slots, or kNoHead.
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const int i = tid + kThreads * j;
      m[j] = kNoHead;
      uint32_t last = 0u;   // the group's last head, 0 if it has none
      if (i - lane < tile_keys) {   // the same for the whole warp
        const bool valid = i < tile_keys;
        const uint32_t d = valid ? select_digit(stage_a[i], stage_b[i], shift,
                                                bits) : kNoHead;
        uint32_t prev = __shfl_up_sync(kFullWarp, d, 1);
        if (lane == 0 && i > 0) {
          prev = select_digit(stage_a[i - 1], stage_b[i - 1], shift, bits);
        }
        const uint32_t heads =
            __ballot_sync(kFullWarp, valid && (i == 0 || prev != d));
        const uint32_t below = heads & lanemask_le;
        if (below) m[j] = i - lane + 31 - __clz(below);
        if (heads) last = i - lane + 31 - __clz(heads);
      }
      if (lane == 0) group_head[kWarps * j + warp] = last;
    }
    __syncthreads();
    // group_head becomes the last head before each group: a running
    // maximum over the groups in slot order (slot 0 is a head), by warp 0,
    // four groups a lane.
    if (warp == 0) {
      uint32_t g[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) g[k] = group_head[4 * lane + k];
      uint32_t incl = max(max(g[0], g[1]), max(g[2], g[3]));
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t up = __shfl_up_sync(kFullWarp, incl, o);
        if (lane >= o) incl = max(incl, up);
      }
      uint32_t carry = __shfl_up_sync(kFullWarp, incl, 1);
      if (lane == 0) carry = 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        group_head[4 * lane + k] = carry;
        carry = max(carry, g[k]);
      }
    }
    __syncthreads();

    // The last slot of each run leaves the run's base at the head's slot.
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const int i = tid + kThreads * j;
      if (i < tile_keys) {
        if (m[j] == kNoHead) m[j] = group_head[kWarps * j + warp];
        const uint32_t d = select_digit(stage_a[i], stage_b[i], shift, bits);
        if (i + 1 == tile_keys ||
            select_digit(stage_a[i + 1], stage_b[i + 1], shift, bits) != d) {
          const uint32_t earlier =
              ONE_TILE ? 0u : fetch_add_u16(table, d, i + 1 - m[j]);
          stage_c[m[j]] = base[d * nb + b] + earlier;
        }
      }
    }
    __syncthreads();

    // Store in slot order; w0 becomes the slot's destination.
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const int i = tid + kThreads * j;
      if (i < tile_keys) {
        w0[j] = stage_c[m[j]] + (i - m[j]);
        out_lo[w0[j]] = stage_a[i];
        out_hi[w0[j]] = stage_b[i];
      }
    }

    // Payload planes as in rank_kernel.
    if (planes.count > 0) __syncthreads();
    for (int p = 0; p < planes.count; ++p) {
      const uint32_t* __restrict__ in = planes.in[p];
      uint32_t* __restrict__ out = planes.out[p];
      uint32_t* const buf = (p & 1) ? stage_b : stage_a;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        if (32 * j < lane_keys) buf[r[j]] = in[g0 + 32 * j];
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int i = tid + kThreads * j;
        if (i < tile_keys) out[w0[j]] = buf[i];
      }
    }
  }
}

constexpr size_t kWideStageBytes = 3 * kTile * sizeof(uint32_t);

// Dynamic shared memory of a wide kernel, set on every call (above 48 KB a
// kernel takes it only after this attribute): `fixed` bytes and, with
// `table`, the radix u16 counters.
template <typename Kernel>
cudaError_t wide_smem(Kernel kernel, size_t fixed, bool table, int bits,
                      size_t* bytes) {
  *bytes = fixed + (table ? static_cast<size_t>(1) << bits << 1 : 0);
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*bytes));
}

inline bool wide_args_ok(int bits, int64_t block) {
  return bits <= kMaxWideBits && block <= kMaxWideBlock;
}

// As many CUDA blocks as the card holds at once, at most `work`: the grid
// of a kernel whose blocks walk over the work in turns.
template <typename Kernel>
cudaError_t resident_grid(Kernel kernel, int threads, size_t smem, int device,
                          int64_t work, unsigned* grid) {
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  *grid = static_cast<unsigned>(work < resident ? work : resident);
  return cudaSuccess;
}

// B1 for 9..16-bit digits: the note at histogram_group_kernel.
template <bool LO, bool HI>
cudaError_t histogram_wide(const uint32_t* lo, const uint32_t* hi, int64_t n,
                           int64_t block, int64_t nb, int shift, int bits,
                           uint32_t* hist, int device, cudaStream_t stream) {
  const auto kernel = histogram_group_kernel<LO, HI>;
  const int window_bits = bits < kWindowBits ? bits : kWindowBits;
  const size_t bytes = kPairs * sizeof(uint32_t) *
                       ((static_cast<size_t>(1) << window_bits) + kGroupPad);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int64_t groups = (nb + kGroup - 1) / kGroup;
  const int64_t items = (((groups - 1) >> kNearBits) + 1)
                        << (bits - window_bits + kNearBits);
  unsigned grid;
  err = resident_grid(kernel, kGroupThreads, bytes, device, items, &grid);
  if (err != cudaSuccess) return err;
  const bool pairs = nb % 2 == 0 && reinterpret_cast<uintptr_t>(hist) % 8 == 0;
  kernel<<<grid, kGroupThreads, bytes, stream>>>(lo, hi, n, block, nb, shift,
                                                 bits, items, pairs, hist);
  return cudaGetLastError();
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits > 8) {
    if (!wide_args_ok(bits, block)) return cudaErrorInvalidValue;
    const auto wide = shift >= 32          ? histogram_wide<false, true>
                      : shift + bits <= 32 ? histogram_wide<true, false>
                                           : histogram_wide<true, true>;
    return wide(lo, hi, n, block, nb, shift, bits, hist, device, st);
  }
  const auto kernel = shift >= 32          ? histogram_kernel<false, true>
                      : shift + bits <= 32 ? histogram_kernel<true, false>
                                           : histogram_kernel<true, true>;
  kernel<<<static_cast<unsigned>(nb), kThreads, 0, st>>>(
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
    err = wide_smem(rank_wide_kernel, 0, true, bits, &bytes);
    if (err != cudaSuccess) return err;
    if (bits > kSparseBits) {
      err = cudaMemsetAsync(hist, 0, (sizeof(uint32_t) << bits) * nb,
                            static_cast<cudaStream_t>(stream));
      if (err != cudaSuccess) return err;
    }
    rank_wide_kernel<<<static_cast<unsigned>(nb), kThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
        lo, hi, n, block, nb, shift, bits, ranks, hist);
    return cudaGetLastError();
  }
  rank_kernel<false><<<static_cast<unsigned>(nb), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
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
    const bool one_tile = block <= kTile;
    const auto kernel = one_tile ? scatter_wide_kernel<true>
                                 : scatter_wide_kernel<false>;
    size_t bytes;
    err = wide_smem(kernel, kWideStageBytes, !one_tile, bits, &bytes);
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<unsigned>(nb), kThreads, bytes,
             static_cast<cudaStream_t>(stream)>>>(
        lo, hi, n, block, nb, shift, bits, base, out_lo, out_hi, planes);
    return cudaGetLastError();
  }
  rank_kernel<true><<<static_cast<unsigned>(nb), kThreads, kStageBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      lo, hi, n, block, nb, shift, bits, base, nullptr, nullptr, out_lo,
      out_hi, planes);
  return cudaGetLastError();
}

}  // extern "C"
