// The inner equi-join's index over a sorted u64 right key (E3).
//
// It replaces no TPU kernel: the JAX package's join is plain jnp
// (tpu_qe/ops/join.py join_sorted + expand_ranges), and so was the port's
// (kernels/join.join_index_plain and join_emit_plain, the plain twins): two
// torch.searchsorted calls over int64 copies of both keys, then an int64
// range expansion over every output slot (counts, a cumsum, two scatters,
// two running maxima, clamps, an arange and adds), ~200 of a ~228 ms SSB
// Q4.1 query at SF 20 on an H100 80GB HBM3.
//
// Two entry points:
// - tq_join_probe: for each left key q, the first sorted right row whose
//   key is >= q (start: the insertion point, as searchsorted side="left")
//   and the number of right keys equal to q (count), as int32; and two
//   exact 64-bit totals, the sum of the counts and the left rows whose count
//   is not 1. Where the second is 0 and the first equals the left rows,
//   the join is the identity on the left and the caller needs no emit.
// - tq_join_emit: from start, count and the exclusive scan of count (B2),
//   the output slots (li, ri) = (i, start[i] + k), k < count[i], as int32,
//   below a budget. Past the budget nothing is written; the totals stay
//   exact.
//
// What bounds it on an H100: bytes. The probe reads the two int32 planes of
// each left key and writes start and count: 16 B a left row (12 B would do
// for a caller that keeps only start), ~0.57 ms for SSB's 120 M fact rows
// at 3.35 TB/s. The emit reads start and count (8 B a left row; B2's scan
// of the counts adds 8 more) and writes 8 B a slot. The search itself must
// stay off the device memory: a plain binary search of a sorted array at a
// random place costs ~log2(m) dependent loads of 32-byte sectors.
//
// Design of the probe:
// - Every block stages a fence of the right key in shared memory: every
//   key when there are at most kFenceAll (SSB's DATE, 2,557 keys), else
//   every 2^s-th key for the least s that leaves at most kFenceMax (SUPPLIER
//   40 k: every 64th; PART 1 M: every 1024th), with the largest key as a
//   sentinel. Its words are 4 bytes where every hi word is 0 (the largest
//   key's is: a lifted 32-bit SQL key), else 8. The grid is persistent (as
//   many blocks as fit on the SMs at once), so the fence is loaded once a
//   block. A small fence keeps the search in shared memory short; the
//   segments behind it stay in L2 (4 MB for PART's 1 M keys).
// - A left key's fence search is a branch-free lower bound in shared
//   memory, the same trip count in every lane. Where the fence is every
//   key, that is the answer and the run is counted there too.
// - Otherwise the answer lies in one segment of 2^s keys between two fence
//   keys a < q <= b, read from the right key's planes (the lo plane alone
//   where every hi word is 0). The guess is the interpolation between a and
//   b, exact for dense keys (every SSB dimension but DATE): the guess and
//   its two neighbours, one sector or two, settle both the start and the
//   count of a unique key. Otherwise the search gallops out from the guess
//   and bisects, a few loads more than a plain bisection at worst, and a
//   run of equal keys is counted by galloping on from start.
// - A thread takes kKeys consecutive left keys with 16-byte loads of each
//   plane and 16-byte stores of start and count, and runs their fence
//   searches and first loads side by side, so that each step has kKeys
//   independent loads in flight; the rare paths are out of line.
// - The totals are reduced in the block and added with one atomic each.
//
// Design of the emit: one thread a left row writes its run at its offset;
// runs longer than kWarpRun are written by the whole warp, a lane a slot,
// so one hot key does not serialise a warp. The offsets come from B2's
// u32 scan: exact while the total is below 2^32. At or past that (4 G
// output rows, more than the card can hold as indices) every slot below
// the budget is written as (0, 0).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using i64 = long long;
using u64 = unsigned long long;

constexpr int kProbeThreads = 512;
constexpr int kProbeWarps = kProbeThreads / 32;
constexpr int kKeys = 4;                 // left keys a thread a step
constexpr int kFenceAll = 4096;          // right keys held whole
constexpr int kFenceMax = 1024;          // else fence keys in shared memory
constexpr int kEmitThreads = 256;
constexpr int kWarpRun = 16;             // longer runs: the whole warp
constexpr uint32_t kFull = 0xFFFFFFFFu;

__device__ __forceinline__ u64 key_of(uint32_t lo, uint32_t hi) {
  return (static_cast<u64>(hi) << 32) | lo;
}

struct Probe {
  const uint32_t* llo;       // left key planes, n
  const uint32_t* lhi;
  i64 n;
  const uint32_t* rlo;       // sorted right key planes, m
  const uint32_t* rhi;
  int m;
  int s;                     // fence stride 2^s
  int nf;                    // fence keys: ceil(m / 2^s)
  bool vec;                  // every plane 16-byte aligned
  int32_t* start;
  int32_t* count;
  u64* totals;               // [sum of counts, counts != 1], zeroed
};

// The sorted right keys a probe searches: the fence in shared memory where
// it holds every key, else the planes. F is the fence's word: uint32_t
// where every hi word is 0 (the largest key's is: a lifted 32-bit SQL key),
// and then the lo plane alone is read, 4 bytes a key; else u64.
template <class F>
struct Keys {
  const F* fence;            // or null
  const uint32_t* lo;
  const uint32_t* hi;
  __device__ __forceinline__ F operator[](int i) const {
    if (fence != nullptr) return fence[i];
    if constexpr (sizeof(F) == 4) {
      return lo[i];
    } else {
      return key_of(lo[i], hi[i]);
    }
  }
};

// The first index in (left, right] whose key is >= q, given
// keys[left] < q <= keys[right] (left may be -1 and right the length,
// which are never read).
template <class K>
__device__ __forceinline__ int bisect(const K& keys, u64 q, int left,
                                      int right) {
  while (right - left > 1) {
    const int mid = left + ((right - left) >> 1);
    if (keys[mid] >= q) {
      right = mid;
    } else {
      left = mid;
    }
  }
  return right;
}

// The number of keys equal to q from p on, in m keys, given keys[p] ==
// keys[p + 1] == q: galloping, then bisecting the last step.
template <class K>
__device__ __noinline__ int run_from(const K keys, int m, int p, u64 q) {
  int lo = p + 1, hi = m;    // keys[lo] == q; keys[hi] != q or hi == m
  for (int d = 2;; d <<= 1) {
    const i64 j = static_cast<i64>(p) + d;
    if (j >= m) break;
    if (keys[static_cast<int>(j)] != q) {
      hi = static_cast<int>(j);
      break;
    }
    lo = static_cast<int>(j);
  }
  while (hi - lo > 1) {
    const int mid = lo + ((hi - lo) >> 1);
    if (keys[mid] == q) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return hi - p;
}

// The lower bound of q in (left, right], keys[left] < q <= keys[right],
// when the guess g in it was not the answer (kg = keys[g]): a gallop out
// from g towards the answer, then a bisection.
template <class K, class F>
__device__ __noinline__ int search_from(const K keys, u64 q, int left,
                                        int right, int g, F kg) {
  if (kg >= q) {
    right = g;
    for (int d = 1;; d <<= 1) {              // gallop down
      const int j = g - d;
      if (j <= left) break;
      if (keys[j] < q) {
        left = j;
        break;
      }
      right = j;
    }
  } else {
    left = g;
    for (int d = 1;; d <<= 1) {              // gallop up
      const i64 j = static_cast<i64>(g) + d;
      if (j >= right) break;
      if (keys[static_cast<int>(j)] >= q) {
        right = static_cast<int>(j);
        break;
      }
      left = static_cast<int>(j);
    }
  }
  return bisect(keys, q, left, right);
}

// Branch-free lower bound in fence[0, nf), nf >= 1: the fence keys < q.
template <class F>
__device__ __forceinline__ int fence_rank(const F* fence, int nf, u64 q) {
  const F* base = fence;
  for (int len = nf; len > 1;) {
    const int half = len >> 1;
    base = static_cast<u64>(base[half]) < q ? base + half : base;
    len -= half;
  }
  return static_cast<int>(base - fence) +
         (static_cast<u64>(*base) < q ? 1 : 0);
}

// A key's match count from its start and the keys at start and after it,
// which settle a unique key without another load.
template <class K, class F>
__device__ __forceinline__ int count_at(const K& keys, int m, int pos, u64 q,
                                        F at, F next) {
  if (pos >= m || at != q) return 0;
  if (pos + 1 >= m || next != q) return 1;
  return run_from(keys, m, pos, q);
}

// The probe of the thread's left rows against a fence of words F, adding
// to the thread's totals.
template <class F>
__device__ __forceinline__ void probe_rows(const Probe& p, const F* fence,
                                           u64& total, u64& odd) {
  const int m = p.m;
  const Keys<F> keys{p.s == 0 ? fence : nullptr, p.rlo, p.rhi};
  const i64 step = static_cast<i64>(gridDim.x) * blockDim.x * kKeys;
  for (i64 i0 = (static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x) *
                kKeys;
       i0 < p.n; i0 += step) {
    const bool full = p.vec && i0 + kKeys <= p.n;
    u64 q[kKeys];
    if (full) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(p.llo + i0));
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(p.lhi + i0));
      q[0] = key_of(a.x, b.x);
      q[1] = key_of(a.y, b.y);
      q[2] = key_of(a.z, b.z);
      q[3] = key_of(a.w, b.w);
    } else {
#pragma unroll
      for (int k = 0; k < kKeys; ++k) {
        const bool in = i0 + k < p.n;
        q[k] = in ? key_of(__ldg(p.llo + i0 + k), __ldg(p.lhi + i0 + k))
                  : 0;
      }
    }
    int pos[kKeys], cnt[kKeys];
#pragma unroll
    for (int k = 0; k < kKeys; ++k) pos[k] = cnt[k] = 0;
    if (m > 0) {
      // Each key's segment (lo, hi] of keys with keys[lo] < q <= keys[hi]
      // and a guess g in it: the fence's answer where the fence holds
      // every key, the first key or none is >= q; else the interpolation
      // between the two fence keys around q.
      int lo[kKeys], hi[kKeys], g[kKeys];
#pragma unroll
      for (int k = 0; k < kKeys; ++k) {
        const int t = fence_rank(fence, p.nf, q[k]);
        lo[k] = -1;
        hi[k] = m;
        g[k] = t;
        if (p.s == 0 || t == 0) continue;
        const u64 a = fence[t - 1];
        const bool last = t == p.nf;
        const u64 b = fence[t];              // the sentinel where last
        if (last && q[k] > b) {
          g[k] = m;                          // past every key
          continue;
        }
        lo[k] = (t - 1) << p.s;
        hi[k] = last ? m - 1 : t << p.s;
        const double f = static_cast<double>(q[k] - a) /
                         static_cast<double>(b - a);
        const int gk = lo[k] + static_cast<int>(__double2ll_rn(
                                   f * static_cast<double>(hi[k] - lo[k])));
        g[k] = gk <= lo[k] ? lo[k] + 1 : (gk > hi[k] ? hi[k] : gk);
      }
      // The guess and its two neighbours, every key's loads in flight:
      // for dense keys (and wherever the fence answered) one sector or
      // two settle the start and the count.
      F kp[kKeys], kg[kKeys], kn[kKeys];
#pragma unroll
      for (int k = 0; k < kKeys; ++k) {
        kp[k] = g[k] - 1 > lo[k] ? keys[g[k] - 1] : 0;
        kg[k] = g[k] < m ? keys[g[k]] : 0;
        kn[k] = g[k] + 1 < m ? keys[g[k] + 1] : 0;
      }
#pragma unroll
      for (int k = 0; k < kKeys; ++k) {
        int at = g[k];
        F kat = kg[k], knext = kn[k];
        if (g[k] < m && (kg[k] < q[k] || (g[k] - 1 > lo[k] &&
                                          kp[k] >= q[k]))) {
          at = search_from(keys, q[k], lo[k], hi[k], g[k], kg[k]);
          kat = keys[at];
          knext = at + 1 < m ? keys[at + 1] : 0;
        }
        pos[k] = at;
        cnt[k] = count_at(keys, m, at, q[k], kat, knext);
      }
    }
#pragma unroll
    for (int k = 0; k < kKeys; ++k) {
      if (i0 + k < p.n) {
        total += static_cast<u64>(cnt[k]);
        odd += cnt[k] != 1 ? 1u : 0u;
      }
    }
    if (full) {
      *reinterpret_cast<int4*>(p.start + i0) =
          make_int4(pos[0], pos[1], pos[2], pos[3]);
      *reinterpret_cast<int4*>(p.count + i0) =
          make_int4(cnt[0], cnt[1], cnt[2], cnt[3]);
    } else {
#pragma unroll
      for (int k = 0; k < kKeys; ++k) {
        if (i0 + k < p.n) {
          p.start[i0 + k] = pos[k];
          p.count[i0 + k] = cnt[k];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kProbeThreads, 2)
join_probe_kernel(Probe p) {
  extern __shared__ u64 fence[];         // nf keys, then the largest key
  __shared__ u64 s_out[kProbeWarps], s_odd[kProbeWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m = p.m;
  const bool narrow = m == 0 || __ldg(p.rhi + m - 1) == 0u;
  uint32_t* fence32 = reinterpret_cast<uint32_t*>(fence);
  for (int j = threadIdx.x; j <= p.nf && m > 0; j += blockDim.x) {
    const i64 r = j < p.nf ? static_cast<i64>(j) << p.s : m - 1;
    if (narrow) {
      fence32[j] = __ldg(p.rlo + r);
    } else {
      fence[j] = key_of(__ldg(p.rlo + r), __ldg(p.rhi + r));
    }
  }
  __syncthreads();
  u64 total = 0, odd = 0;
  if (narrow) {
    probe_rows(p, fence32, total, odd);
  } else {
    probe_rows(p, fence, total, odd);
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    total += __shfl_xor_sync(kFull, total, o);
    odd += __shfl_xor_sync(kFull, odd, o);
  }
  if (lane == 0) {
    s_out[warp] = total;
    s_odd[warp] = odd;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    u64 a = 0, b = 0;
#pragma unroll
    for (int w = 0; w < kProbeWarps; ++w) {
      a += s_out[w];
      b += s_odd[w];
    }
    if (a) atomicAdd(p.totals, a);
    if (b) atomicAdd(p.totals + 1, b);
  }
}

__global__ void __launch_bounds__(kEmitThreads)
join_emit_kernel(const int32_t* start, const int32_t* count,
                 const uint32_t* offsets, i64 n, const u64* totals,
                 i64 budget, int32_t* li, int32_t* ri) {
  const i64 tid = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (*totals > 0xFFFFFFFFull) {         // the u32 offsets wrapped
    const i64 stride = static_cast<i64>(gridDim.x) * blockDim.x;
    for (i64 j = tid; j < budget; j += stride) {
      li[j] = 0;
      ri[j] = 0;
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  i64 o = 0;
  int c = 0, st = 0;
  if (tid < n) {
    c = __ldg(count + tid);
    if (c > 0) {
      o = __ldg(offsets + tid);
      st = __ldg(start + tid);
      const i64 room = budget - o;
      c = room <= 0 ? 0 : (c > room ? static_cast<int>(room) : c);
    }
  }
  const bool wide = c > kWarpRun;
  if (!wide) {
    for (int k = 0; k < c; ++k) {
      li[o + k] = static_cast<int32_t>(tid);
      ri[o + k] = st + k;
    }
  }
  for (uint32_t w = __ballot_sync(kFull, wide); w; w &= w - 1) {
    const int src = __ffs(w) - 1;
    const i64 wo = __shfl_sync(kFull, o, src);
    const int wc = __shfl_sync(kFull, c, src);
    const int wst = __shfl_sync(kFull, st, src);
    const int32_t wi = static_cast<int32_t>(tid - lane + src);
    for (int k = lane; k < wc; k += 32) {
      li[wo + k] = wi;
      ri[wo + k] = wst + k;
    }
  }
}

// The fence stride 2^s: every key where kFenceAll hold them, else the
// least s whose fence of ceil(m / 2^s) keys is at most kFenceMax.
int fence_shift(i64 m) {
  if (m <= kFenceAll) return 0;
  int s = 1;
  while (((m + (i64{1} << s) - 1) >> s) > kFenceMax) ++s;
  return s;
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

extern "C" {

// llo, lhi: (n,) left key planes; rlo, rhi: (m,) right key planes sorted
// ascending as u64; 0 <= n, m < 2^31 - 1. Writes start, count: (n,) int32; and
// totals: two int64 on the device, the sum of the counts and the number of
// rows whose count is not 1. Returns the first CUDA error.
int tq_join_probe(const uint32_t* llo, const uint32_t* lhi, int64_t n,
                  const uint32_t* rlo, const uint32_t* rhi, int64_t m,
                  int32_t* start, int32_t* count, int64_t* totals,
                  int device, void* stream) {
  if (n < 0 || m < 0 || n >= 0x7FFFFFFF || m >= 0x7FFFFFFF) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(totals, 0, 2 * sizeof(int64_t), st);
  if (err != cudaSuccess || n == 0) return err;
  const int s = fence_shift(m);
  const int nf = static_cast<int>((m + (i64{1} << s) - 1) >> s);
  const size_t smem = (static_cast<size_t>(nf) + 1) * sizeof(u64);
  err = cudaFuncSetAttribute(join_probe_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, join_probe_kernel, kProbeThreads, smem);
  if (err != cudaSuccess) return err;
  const i64 need = (n + i64{kProbeThreads} * kKeys - 1) /
                   (i64{kProbeThreads} * kKeys);
  const i64 fit = static_cast<i64>(sms) * (per_sm > 0 ? per_sm : 1);
  const Probe p{llo, lhi, n, rlo, rhi, static_cast<int>(m), s, nf,
                aligned16(llo) && aligned16(lhi) && aligned16(start) &&
                    aligned16(count),
                start, count, reinterpret_cast<u64*>(totals)};
  join_probe_kernel<<<static_cast<unsigned>(need < fit ? need : fit),
                      kProbeThreads, smem, st>>>(p);
  return cudaGetLastError();
}

// start, count: (n,) int32 from tq_join_probe; offsets: (n,) the u32
// exclusive scan of count; totals: tq_join_probe's. Writes li, ri: the
// slots below budget (1 <= budget < 2^31), (i, start[i] + k) for the k-th
// match of left row i at slot offsets[i] + k; slots from the sum of the
// counts to budget are left as they were. Returns the first CUDA error.
int tq_join_emit(const int32_t* start, const int32_t* count,
                 const int32_t* offsets, int64_t n, const int64_t* totals,
                 int64_t budget, int32_t* li, int32_t* ri, int device,
                 void* stream) {
  if (n < 0 || n > 0x7FFFFFFF || budget < 1 || budget > 0x7FFFFFFF) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  i64 blocks = (n + kEmitThreads - 1) / kEmitThreads;
  blocks = blocks < 1 ? 1 : blocks;
  join_emit_kernel<<<static_cast<unsigned>(blocks), kEmitThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      start, count, reinterpret_cast<const uint32_t*>(offsets), n,
      reinterpret_cast<const u64*>(totals), budget, li, ri);
  return cudaGetLastError();
}

}  // extern "C"
