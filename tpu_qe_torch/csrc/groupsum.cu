// Reduce-by-key of GROUP BY's counts and exact integer sums over key-sorted
// rows (E2).
//
// It replaces no TPU kernel: the JAX package computes these in plain jnp
// (tpu_qe/ops/aggregate.py), and so did the port
// (kernels/groupsum.segment_sums_plain, the plain twin): per value column a
// gather by the sort permutation, an int64 prefix sum and its narrowing to
// two int32 planes, then gathers and a borrow subtraction at the group
// ends, some 150-200 bytes of device traffic a row a column in ~25 eager
// launches: on an H100 80GB HBM3 ~85 of a ~113 ms TPC-H Q1 request at
// SF 10.
//
// Input: rows sorted by (invalid flag, key), the int32 or int64
// permutation that sorted them, and up to kMaxCols value columns in their
// original order. A valid row ends its group when the next row is invalid,
// has another key, or does not exist; a group is every row after the
// previous end up to its own (invalid rows, sorted to the tail, end none).
// Output, for each group g below cap: its end row, its row count, its key
// and per column the u64 sum of its values (u32 zero-extended; i32
// sign-extended, which gives the two's-complement sum mod 2^64) as lo / hi
// words; and the exact number of groups, past cap too.
//
// What bounds it on an H100: bytes. The key words (8 B), the permutation
// (4 or 8 B) and K gathered 4-byte values a row at 3.35 TB/s; there is
// nothing to compute but adds. Where groups interleave in the original row
// order (Q1's four), the gathers of one group touch each 32-byte sector of
// a column without using all of it, and each sector is fetched again for
// the next group: that, not the bound, sets the time there. On an H100
// 80GB HBM3 at Q1's shape (59 M rows, 6 columns, 4 groups) it took 1.94
// ms against a 0.63 ms byte bound and a 1.41 ms model of the sectors its
// gathers fetch (2.84 a value sector); at 2^24 rows in 2^20 groups 3.83
// ms against 0.20 and 1.04, where pass 3's shuffles set it.
//
// Design: tiles of kTile rows, a warp 512 of them, a lane one row a step,
// so that the key and permutation loads coalesce and the gathers of one
// step fall on nearby rows. Three launches, no atomics, each value read
// once and the keys at most twice:
// 1. groupsum_tile_kernel: a tile's end flags from the keys, its end count
//    and last end row, and the sums of the rows after its last end (its
//    tail): only those rows are gathered.
// 2. groupsum_carry_kernel: one block scans the tiles' records into each
//    tile's first group index, the last end row before it and the sums
//    carried into it (the rows after that end and before the tile).
// 3. groupsum_emit_kernel: a tile with an end gathers the rows up to its
//    last end and writes its groups; the group that began before it adds
//    the carry. A tile without an end returns at once, so with few groups
//    (Q1: 4 groups of ~15 M rows across thousands of tiles) the rows are
//    gathered once, in pass 1, and with many (every row its own group) once
//    too, in pass 3. Inside a step a warp ballots its end flags: a step
//    without one adds each lane's value into the lane's running sums; a
//    step with some sums the runs between them with a segmented shuffle
//    scan and the open group's running sums over the lanes.
// Loads of kBatch steps are issued before any is used. Any n >= 1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using i64 = long long;
using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 16;                     // rows a lane
constexpr int kBatch = 4;                      // steps loaded at once
constexpr i64 kWarpRows = 32 * kSteps;
constexpr i64 kTile = kWarpRows * kWarps;      // 4096 rows
constexpr int kMaxCols = 8;
constexpr int kCarryThreads = 1024;
constexpr uint32_t kFull = 0xFFFFFFFFu;

__host__ __device__ constexpr int slots(int k) { return k > 0 ? k : 1; }

struct Rows {
  const uint32_t* slo;       // sorted key words
  const uint32_t* shi;
  const uint8_t* invalid;    // sorted invalid flags, or null
  const void* perm;          // sorted row -> original row, int32 or int64
  int perm_bytes;            // 4 or 8
  i64 n;
};

struct Cols {
  const uint32_t* v[kMaxCols];   // value columns, original row order
  uint32_t* lo[kMaxCols];        // per-group sums, low and high words
  uint32_t* hi[kMaxCols];
  uint32_t sign;                 // bit k: column k is i32
};

struct Out {
  i64* end;                  // per group: its last row, its rows, its key
  i64* count;
  uint32_t* klo;
  uint32_t* khi;
  i64 cap;
  i64* num_groups;
};

// Scratch records a tile: pass 1 writes ends, last, tail; pass 2 base,
// prev, carry. tail and carry hold K words a tile.
struct Tiles {
  i64* ends;
  i64* last;
  u64* tail;
  i64* base;
  i64* prev;
  u64* carry;
  i64 count;
};

__device__ __forceinline__ u64 extend(uint32_t x, uint32_t sign, int k) {
  return ((sign >> k) & 1u) ? static_cast<u64>(static_cast<i64>(
                                  static_cast<int32_t>(x)))
                            : static_cast<u64>(x);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ u64 warp_sum(u64 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ i64 warp_max(i64 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const i64 w = __shfl_xor_sync(kFull, v, o);
    v = w > v ? w : v;
  }
  return v;
}

// Bit s: row w0 + 32 s + lane ends its group. Called by a whole warp.
__device__ __forceinline__ uint32_t end_bits(const Rows& r, i64 w0,
                                             int lane) {
  uint32_t bits = 0u;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const i64 i = w0 + 32 * s + lane;
    uint32_t lo = 0u, hi = 0u, inv = 1u;       // past the end: invalid
    if (i < r.n) {
      lo = __ldg(r.slo + i);
      hi = __ldg(r.shi + i);
      inv = r.invalid != nullptr ? __ldg(r.invalid + i) : 0u;
    }
    uint32_t nlo = __shfl_down_sync(kFull, lo, 1);
    uint32_t nhi = __shfl_down_sync(kFull, hi, 1);
    uint32_t ninv = __shfl_down_sync(kFull, inv, 1);
    if (lane == 31) {
      ninv = 1u;
      if (i + 1 < r.n) {
        nlo = __ldg(r.slo + i + 1);
        nhi = __ldg(r.shi + i + 1);
        ninv = r.invalid != nullptr ? __ldg(r.invalid + i + 1) : 0u;
      }
    }
    const bool end = i < r.n && !inv && (ninv || nlo != lo || nhi != hi);
    bits |= static_cast<uint32_t>(end) << s;
  }
  return bits;
}

__device__ __forceinline__ i64 load_perm(const Rows& r, i64 i) {
  if (r.perm_bytes == 4) {
    return __ldg(static_cast<const int32_t*>(r.perm) + i);
  }
  return __ldg(static_cast<const i64*>(r.perm) + i);
}

// v[b][k]: column k at row i0 + 32 b where that row lies in [first, last],
// else 0. The permutation loads go out first, then every gather.
template <int K>
__device__ __forceinline__ void gather(const Rows& r, const Cols& c, i64 i0,
                                       i64 first, i64 last,
                                       uint32_t (&v)[kBatch][slots(K)]) {
  i64 p[kBatch];
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    const i64 i = i0 + 32 * b;
    p[b] = (K > 0 && i >= first && i <= last) ? load_perm(r, i) : -1;
  }
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
#pragma unroll
    for (int k = 0; k < slots(K); ++k) {
      v[b][k] = (k < K && p[b] >= 0) ? __ldg(c.v[k] + p[b]) : 0u;
    }
  }
}

// Pass 1: a tile's end count, last end row and tail sums.
template <int K>
__global__ void __launch_bounds__(kThreads)
groupsum_tile_kernel(Rows r, Cols c, Tiles t) {
  __shared__ int s_ends[kWarps];
  __shared__ i64 s_last[kWarps];
  __shared__ u64 s_tail[kWarps][slots(K)];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const i64 tile = blockIdx.x;
  const i64 w0 = tile * kTile + warp * kWarpRows;

  const uint32_t bits = end_bits(r, w0, lane);
  const int ends = warp_sum(__popc(bits));
  const i64 last = warp_max(
      bits ? w0 + 32 * (31 - __clz(bits)) + lane : i64{-1});
  if (lane == 0) {
    s_ends[warp] = ends;
    s_last[warp] = last;
  }
  __syncthreads();
  int tile_ends = 0;
  i64 tile_last = -1;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    tile_ends += s_ends[w];
    tile_last = s_last[w] > tile_last ? s_last[w] : tile_last;
  }

  u64 acc[slots(K)] = {};
  if (K > 0) {
    for (int s0 = 0; s0 < kSteps; s0 += kBatch) {
      if (w0 + 32 * s0 >= r.n) break;
      if (w0 + 32 * (s0 + kBatch) - 1 <= tile_last) continue;
      uint32_t v[kBatch][slots(K)];
      gather<K>(r, c, w0 + 32 * s0 + lane, tile_last + 1, r.n - 1, v);
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k] += extend(v[b][k], c.sign, k);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      acc[k] = warp_sum(acc[k]);
      if (lane == 0) s_tail[warp][k] = acc[k];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    t.ends[tile] = tile_ends;
    t.last[tile] = tile_last;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      u64 s = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += s_tail[w][k];
      t.tail[tile * K + k] = s;
    }
  }
}

// What a run of rows carries forward: the ends in it, its last end row
// (-1: none) and the sums of its rows after that end.
template <int K>
struct Carry {
  i64 e;
  i64 last;
  u64 s[slots(K)];
};

template <int K>
__device__ __forceinline__ Carry<K> nothing() {
  Carry<K> x;
  x.e = 0;
  x.last = -1;
#pragma unroll
  for (int k = 0; k < slots(K); ++k) x.s[k] = 0;
  return x;
}

// a, then b.
template <int K>
__device__ __forceinline__ Carry<K> combine(const Carry<K>& a,
                                            const Carry<K>& b) {
  Carry<K> x;
  x.e = a.e + b.e;
  x.last = b.e ? b.last : a.last;
#pragma unroll
  for (int k = 0; k < slots(K); ++k) x.s[k] = b.e ? b.s[k] : a.s[k] + b.s[k];
  return x;
}

template <int K>
__device__ __forceinline__ Carry<K> shfl_up(const Carry<K>& a, int o) {
  Carry<K> x;
  x.e = __shfl_up_sync(kFull, a.e, o);
  x.last = __shfl_up_sync(kFull, a.last, o);
#pragma unroll
  for (int k = 0; k < slots(K); ++k) x.s[k] = __shfl_up_sync(kFull, a.s[k], o);
  return x;
}

template <int K>
__device__ __forceinline__ Carry<K> tile_record(const Tiles& t, i64 i) {
  Carry<K> x;
  x.e = t.ends[i];
  x.last = t.last[i];
#pragma unroll
  for (int k = 0; k < slots(K); ++k) x.s[k] = k < K ? t.tail[i * K + k] : 0;
  return x;
}

// Inclusive scan of one record a lane, in lane order.
template <int K>
__device__ __forceinline__ Carry<K> warp_scan(Carry<K> x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Carry<K> y = shfl_up(x, o);
    if (lane >= o) x = combine(y, x);
  }
  return x;
}

// Pass 2, one block: each thread folds a run of tiles, the block scans the
// runs, and each thread writes its tiles' exclusive prefixes.
template <int K>
__global__ void __launch_bounds__(kCarryThreads)
groupsum_carry_kernel(Tiles t, i64* num_groups) {
  __shared__ Carry<K> s_warp[kCarryThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const i64 run = (t.count + kCarryThreads - 1) / kCarryThreads;
  const i64 begin = tid * run < t.count ? tid * run : t.count;
  const i64 end = begin + run < t.count ? begin + run : t.count;

  Carry<K> own = nothing<K>();
  for (i64 i = begin; i < end; ++i) own = combine(own, tile_record<K>(t, i));
  const Carry<K> inc = warp_scan(own, lane);
  Carry<K> x = shfl_up(inc, 1);         // exclusive, inside the warp
  if (lane == 0) x = nothing<K>();
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const Carry<K> w = warp_scan(s_warp[lane], lane);
    Carry<K> before = shfl_up(w, 1);
    if (lane == 0) before = nothing<K>();
    s_warp[lane] = before;
  }
  __syncthreads();
  x = combine(s_warp[warp], x);
  for (i64 i = begin; i < end; ++i) {
    t.base[i] = x.e;
    t.prev[i] = x.last;
#pragma unroll
    for (int k = 0; k < K; ++k) t.carry[i * K + k] = x.s[k];
    x = combine(x, tile_record<K>(t, i));
  }
  if (begin < end && end == t.count) *num_groups = x.e;
}

// Pass 3: the groups that end in a tile.
template <int K>
__global__ void __launch_bounds__(kThreads)
groupsum_emit_kernel(Rows r, Cols c, Tiles t, Out out) {
  const i64 tile = blockIdx.x;
  if (t.ends[tile] == 0) return;
  __shared__ int s_ends[kWarps];
  __shared__ i64 s_last[kWarps];
  __shared__ u64 s_tail[kWarps][slots(K)];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const i64 w0 = tile * kTile + warp * kWarpRows;

  const uint32_t bits = end_bits(r, w0, lane);
  const int ends = warp_sum(__popc(bits));
  const i64 last = warp_max(
      bits ? w0 + 32 * (31 - __clz(bits)) + lane : i64{-1});
  if (lane == 0) {
    s_ends[warp] = ends;
    s_last[warp] = last;
  }
  __syncthreads();
  i64 g = t.base[tile];        // the warp's next group
  i64 prev = t.prev[tile];     // the end row before it
  i64 tile_last = -1;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) {
      g += s_ends[w];
      prev = s_last[w] > prev ? s_last[w] : prev;
    }
    tile_last = s_last[w] > tile_last ? s_last[w] : tile_last;
  }

  // acc: the open group's rows, a lane's share; head: the sums of the
  // warp's first group without what came before the warp (lane head_g's)
  u64 acc[slots(K)] = {}, head[slots(K)] = {};
  i64 head_g = -1;
  bool first = true;
  for (int s0 = 0; s0 < kSteps; s0 += kBatch) {
    if (w0 + 32 * s0 > tile_last) break;
    uint32_t v[kBatch][slots(K)];
    gather<K>(r, c, w0 + 32 * s0 + lane, w0, tile_last, v);
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int s = s0 + b;
      const i64 row0 = w0 + 32 * s;
      const uint32_t em = __ballot_sync(kFull, (bits >> s) & 1u);
      if (em == 0u) {
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k] += extend(v[b][k], c.sign, k);
        continue;
      }
      // x: the sum of this step's run up to the lane, runs starting after
      // each end (segmented scan); tot: the open group's rows before it
      u64 x[slots(K)], tot[slots(K)];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        x[k] = extend(v[b][k], c.sign, k);
        tot[k] = warp_sum(acc[k]);
      }
      int f = lane == 0 || ((em >> (lane - 1)) & 1u);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int fo = __shfl_up_sync(kFull, f, o);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const u64 y = __shfl_up_sync(kFull, x[k], o);
          if (lane >= o && !f) x[k] += y;
        }
        if (lane >= o) f |= fo;
      }
      if ((em >> lane) & 1u) {
        const i64 i = row0 + lane;
        const uint32_t below = em & ((1u << lane) - 1u);
        const i64 gi = g + __popc(below);
        if (!below) {
#pragma unroll
          for (int k = 0; k < K; ++k) x[k] += tot[k];
        }
        if (gi < out.cap) {
          out.end[gi] = i;
          out.count[gi] = i - (below ? row0 + 31 - __clz(below) : prev);
          out.klo[gi] = __ldg(r.slo + i);
          out.khi[gi] = __ldg(r.shi + i);
        }
        if (first && !below) {
          head_g = gi;
#pragma unroll
          for (int k = 0; k < K; ++k) head[k] = x[k];
        } else if (gi < out.cap) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            c.lo[k][gi] = static_cast<uint32_t>(x[k]);
            c.hi[k][gi] = static_cast<uint32_t>(x[k] >> 32);
          }
        }
      }
      first = false;
      g += __popc(em);
      const int last_lane = 31 - __clz(em);
      prev = row0 + last_lane;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        acc[k] = lane > last_lane ? extend(v[b][k], c.sign, k) : 0;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    acc[k] = warp_sum(acc[k]);
    if (lane == 0) s_tail[warp][k] = acc[k];
  }
  __syncthreads();
  if (head_g >= 0 && head_g < out.cap) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      u64 carry = t.carry[tile * K + k];
      for (int w = 0; w < warp; ++w) {
        carry = s_ends[w] ? s_tail[w][k] : carry + s_tail[w][k];
      }
      const u64 sum = head[k] + carry;
      c.lo[k][head_g] = static_cast<uint32_t>(sum);
      c.hi[k][head_g] = static_cast<uint32_t>(sum >> 32);
    }
  }
}

i64 num_tiles(i64 n) { return (n + kTile - 1) / kTile; }

template <int K>
int launch(const Rows& r, const Cols& c, const Tiles& t, const Out& o,
           cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>(t.count);
  groupsum_tile_kernel<K><<<grid, kThreads, 0, s>>>(r, c, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  groupsum_carry_kernel<K><<<1, kCarryThreads, 0, s>>>(t, o.num_groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  groupsum_emit_kernel<K><<<grid, kThreads, 0, s>>>(r, c, t, o);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// int64 words of scratch tq_group_sums needs for n rows and k columns.
int64_t tq_group_sums_scratch(int64_t n, int k) {
  return num_tiles(n) * (4 + 2 * static_cast<int64_t>(k));
}

// slo, shi: (n,) sorted key words; invalid: (n,) sorted 0/1 flags or null;
// perm: (n,) int32 (perm_bytes 4) or int64 (8), every entry in [0, n);
// cols: k host-held pointers to (n,) value columns in original row order,
// bit j of sign set where column j is i32. Per group g < cap: end[g],
// count[g], klo[g], khi[g], and sum_lo[j][g], sum_hi[j][g] (k host-held
// pointers to (cap,) words); the entries from the group count to cap are
// left as they were. num_groups: one int64 on the device. scratch:
// tq_group_sums_scratch(n, k) int64 words, any contents. 0 <= k <= 8,
// n >= 1. Returns the first CUDA error.
int tq_group_sums(const uint32_t* slo, const uint32_t* shi,
                  const uint8_t* invalid, const void* perm, int perm_bytes,
                  int64_t n,
                  const uint32_t* const* cols, uint32_t sign, int k,
                  int64_t cap, int64_t* end, int64_t* count, uint32_t* klo,
                  uint32_t* khi, uint32_t* const* sum_lo,
                  uint32_t* const* sum_hi, int64_t* num_groups,
                  int64_t* scratch, int device, void* stream) {
  if (k < 0 || k > kMaxCols || n < 1 || cap < 0 ||
      (perm_bytes != 4 && perm_bytes != 8)) {
    return cudaErrorInvalidValue;
  }
  const i64 tiles = num_tiles(n);
  if (tiles > 0x7FFFFFFF) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Rows r{slo, shi, invalid, perm, perm_bytes, n};
  Cols c{};
  for (int j = 0; j < k; ++j) {
    c.v[j] = cols[j];
    c.lo[j] = sum_lo[j];
    c.hi[j] = sum_hi[j];
  }
  c.sign = sign;
  const Out o{reinterpret_cast<i64*>(end), reinterpret_cast<i64*>(count),
              klo, khi, cap, reinterpret_cast<i64*>(num_groups)};
  i64* w = reinterpret_cast<i64*>(scratch);
  const Tiles t{w,
                w + tiles,
                reinterpret_cast<u64*>(w + 2 * tiles),
                w + (2 + k) * tiles,
                w + (3 + k) * tiles,
                reinterpret_cast<u64*>(w + (4 + k) * tiles),
                tiles};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 0: return launch<0>(r, c, t, o, s);
    case 1: return launch<1>(r, c, t, o, s);
    case 2: return launch<2>(r, c, t, o, s);
    case 3: return launch<3>(r, c, t, o, s);
    case 4: return launch<4>(r, c, t, o, s);
    case 5: return launch<5>(r, c, t, o, s);
    case 6: return launch<6>(r, c, t, o, s);
    case 7: return launch<7>(r, c, t, o, s);
    default: return launch<8>(r, c, t, o, s);
  }
}

}  // extern "C"
