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

// ---------------------------------------------------------------------------
// The fused encode: the whole of tpu_qe_torch/morton.py's `quantize` +
// `encode_quantized` (and of `quantize_points` + `encode_quantized`) in one
// pass, with no temporaries in device memory. It replaces no TPU kernel: the
// JAX package's encode is plain jnp, and the port's plain twin of it ran
// ~250 eager int64 launches over the keys.
//
// Per triangle: its three vertex indices (read once, streaming), three
// vertex rows of 12 bytes gathered from the vertex array, the AABB's
// centroid quantized to 20-bit cells and its diagonal to a 12-bit size
// index, then the 64-bit key built in two u32 registers. Per columnar point
// the same without the gathers, the point itself as the centroid and an
// optional size as the diagonal (0 without one).
//
// Float order is op-exact against the -ffp-contract=off C++ oracle
// (cpp/core.cc quantize_coord / quantize_size) and the plain twin: every
// float op is an explicit round-to-nearest intrinsic, so nvcc cannot
// contract a multiply and an add into an FMA whatever the library's flags:
//   u32 clamp(((min + max) * 0.5 - offset) * multiplier - 0.001, 0, 2^20-1)
//   u32 clamp(sqrt((dx*dx + dy*dy) + dz*dz) * size_multiplier, 0, 4095)
// fmaxf(v, 0) maps NaN to 0, as the oracle's !(v > 0) does.
//
// Bound by bytes, the random vertex sectors most of all: at 2^26 triangles
// over a 268 MB vertex array (larger than the 50 MB L2) each 12-byte row
// costs one or two 32-byte DRAM sectors, against 12 bytes of indices read
// and 8 of key written per triangle. So each thread takes kItems triangles
// and issues all their index loads, then all 9 * kItems vertex loads,
// before it uses any; the lanes of a warp take consecutive triangles, so
// the index loads and key stores coalesce; indices and keys go with
// evict-first hints (__ldcs / __stcs) so that the stream does not push the
// vertex rows, each read ~9 times a frame, out of L2. The interleave is
// integer work in registers, free beside the gathers. A ragged tail is
// masked, so any n is taken; n = 0 launches nothing. On an H100 80GB HBM3
// at 2^26 triangles it took 7.0 ms against a 2.8 ms sector bound, and 1, 2
// or 8 items a thread, 8-byte row loads or more blocks an SM all took 6.9-
// 8.1 ms: the random DRAM accesses, not issue rate or occupancy, set it.

namespace {

constexpr int kFusedThreads = 256;
constexpr int kItems = 4;                    // triangles or points a thread
constexpr int64_t kTile = static_cast<int64_t>(kFusedThreads) * kItems;
constexpr float kCoordMaxF = 1048575.0f;     // 2^20 - 1
constexpr float kSizeIndexMaxF = 4095.0f;    // 2^12 - 1

struct Uniforms {
  float offset[3];
  float multiplier[3];
  float size_multiplier;
};

__device__ __forceinline__ uint32_t quantize_coord(float c, float offset,
                                                   float mult) {
  const float v = __fsub_rn(__fmul_rn(__fsub_rn(c, offset), mult), 0.001f);
  return __float2uint_rz(fminf(fmaxf(v, 0.0f), kCoordMaxF));
}

__device__ __forceinline__ uint32_t quantize_size(float len, float mult) {
  const float v = __fmul_rn(len, mult);
  return __float2uint_rz(fminf(fmaxf(v, 0.0f), kSizeIndexMaxF));
}

// Bits 0..4 of x to bits 0, 3, 6, 9, 12.
__device__ __forceinline__ uint32_t spread5(uint32_t x) {
  x &= 0x1Fu;
  x = (x | (x << 8)) & 0x100Fu;
  x = (x | (x << 4)) & 0x10C3u;
  x = (x | (x << 2)) & 0x1249u;
  return x;
}

// The extended-morton key of cell (qx, qy, qz) and size index j, as
// tpu_qe_torch/morton.py's coord_bit_position / size_bit_position lay it
// out: four 16-bit groups from the top, group g holding coordinate levels
// 5g..5g+4 (bits 19-5g..15-5g of each q; per level x, y, z from the
// group's bit 15 down) over size bit 3-g of j >> 8 at the group's bit 0.
__device__ __forceinline__ void interleave(uint32_t qx, uint32_t qy,
                                           uint32_t qz, uint32_t j,
                                           uint32_t& lo, uint32_t& hi) {
  const uint32_t s = j >> 8;
  uint32_t group[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const int sh = 15 - 5 * g;
    group[g] = (spread5(qx >> sh) << 3) | (spread5(qy >> sh) << 2) |
               (spread5(qz >> sh) << 1) | ((s >> (3 - g)) & 1u);
  }
  hi = (group[0] << 16) | group[1];
  lo = (group[2] << 16) | group[3];
}

// Input forms of morton_fused_kernel: load() issues an item's first loads,
// fetch() the loads that depend on them, shape() gives its centroid and the
// length whose size index is taken.
template <typename Index>
struct Triangles {
  const float* __restrict__ verts;   // (V, 3)
  const Index* __restrict__ tris;    // (n, 3)
  struct Item {
    Index corner[3];
    float v[9];
  };
  __device__ __forceinline__ void load(int64_t t, Item& it) const {
#pragma unroll
    for (int c = 0; c < 3; ++c) it.corner[c] = __ldcs(tris + 3 * t + c);
  }
  __device__ __forceinline__ void fetch(Item& it) const {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* row = verts + 3 * static_cast<int64_t>(it.corner[c]);
#pragma unroll
      for (int a = 0; a < 3; ++a) it.v[3 * c + a] = __ldg(row + a);
    }
  }
  __device__ __forceinline__ void shape(const Item& it, float c[3],
                                        float& len) const {
    float ext[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float mn = fminf(fminf(it.v[a], it.v[3 + a]), it.v[6 + a]);
      const float mx = fmaxf(fmaxf(it.v[a], it.v[3 + a]), it.v[6 + a]);
      c[a] = __fmul_rn(__fadd_rn(mn, mx), 0.5f);
      ext[a] = __fsub_rn(mx, mn);
    }
    len = __fsqrt_rn(__fadd_rn(
        __fadd_rn(__fmul_rn(ext[0], ext[0]), __fmul_rn(ext[1], ext[1])),
        __fmul_rn(ext[2], ext[2])));
  }
};

struct Points {
  const float* __restrict__ x;
  const float* __restrict__ y;
  const float* __restrict__ z;
  const float* __restrict__ size;    // nullptr: every size index is 0
  struct Item {
    float c[3];
    float len;
  };
  __device__ __forceinline__ void load(int64_t i, Item& it) const {
    it.c[0] = __ldcs(x + i);
    it.c[1] = __ldcs(y + i);
    it.c[2] = __ldcs(z + i);
    it.len = size != nullptr ? __ldcs(size + i) : 0.0f;
  }
  __device__ __forceinline__ void fetch(Item&) const {}
  __device__ __forceinline__ void shape(const Item& it, float c[3],
                                        float& len) const {
#pragma unroll
    for (int a = 0; a < 3; ++a) c[a] = it.c[a];
    len = it.len;
  }
};

template <class Input>
__global__ void __launch_bounds__(kFusedThreads)
morton_fused_kernel(Input in, const float* __restrict__ offset,
                    const float* __restrict__ multiplier,
                    const float* __restrict__ size_multiplier, int64_t n,
                    uint32_t* __restrict__ out_lo,
                    uint32_t* __restrict__ out_hi) {
  __shared__ Uniforms u;
  if (threadIdx.x < 3) {
    u.offset[threadIdx.x] = offset[threadIdx.x];
    u.multiplier[threadIdx.x] = multiplier[threadIdx.x];
  } else if (threadIdx.x == 3) {
    u.size_multiplier = *size_multiplier;
  }
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kTile;
  for (int64_t base = blockIdx.x * kTile + threadIdx.x; base < n;
       base += stride) {
    typename Input::Item item[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t i = base + k * kFusedThreads;
      if (i < n) in.load(i, item[k]);
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (base + k * kFusedThreads < n) in.fetch(item[k]);
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t i = base + k * kFusedThreads;
      if (i >= n) break;
      float c[3], len;
      in.shape(item[k], c, len);
      uint32_t lo, hi;
      interleave(quantize_coord(c[0], u.offset[0], u.multiplier[0]),
                 quantize_coord(c[1], u.offset[1], u.multiplier[1]),
                 quantize_coord(c[2], u.offset[2], u.multiplier[2]),
                 quantize_size(len, u.size_multiplier), lo, hi);
      __stcs(out_lo + i, lo);
      __stcs(out_hi + i, hi);
    }
  }
}

template <class Input>
int launch_fused(const Input& in, const float* offset,
                 const float* multiplier, const float* size_multiplier,
                 int64_t n, uint32_t* out_lo, uint32_t* out_hi, int device,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  const int64_t tiles = (n + kTile - 1) / kTile;
  const unsigned grid =
      static_cast<unsigned>(tiles < 0x7FFFFFFF ? tiles : 0x7FFFFFFF);
  morton_fused_kernel<Input>
      <<<grid, kFusedThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          in, offset, multiplier, size_multiplier, n, out_lo, out_hi);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// verts: (V, 3) f32; tris: (n, 3) int32 (index_bytes 4) or int64 (8), every
// index in [0, V); offset, multiplier: (3,) f32 and size_multiplier: () f32
// on the device (MortonParams' own tensors); out_lo/out_hi: (n,) u32.
// Returns cudaGetLastError.
int tq_morton_encode_triangles(const float* verts, const void* tris,
                               int index_bytes, int64_t n,
                               const float* offset, const float* multiplier,
                               const float* size_multiplier, uint32_t* out_lo,
                               uint32_t* out_hi, int device, void* stream) {
  if (index_bytes == 4) {
    return launch_fused(
        Triangles<int32_t>{verts, static_cast<const int32_t*>(tris)}, offset,
        multiplier, size_multiplier, n, out_lo, out_hi, device, stream);
  }
  if (index_bytes == 8) {
    return launch_fused(
        Triangles<long long>{verts, static_cast<const long long*>(tris)},
        offset, multiplier, size_multiplier, n, out_lo, out_hi, device,
        stream);
  }
  return cudaErrorInvalidValue;
}

// x, y, z: (n,) f32 columns; size: (n,) f32 or null (size index 0); the
// uniforms and outputs as tq_morton_encode_triangles. Returns
// cudaGetLastError.
int tq_morton_encode_points(const float* x, const float* y, const float* z,
                            const float* size, int64_t n, const float* offset,
                            const float* multiplier,
                            const float* size_multiplier, uint32_t* out_lo,
                            uint32_t* out_hi, int device, void* stream) {
  return launch_fused(Points{x, y, z, size}, offset, multiplier,
                      size_multiplier, n, out_lo, out_hi, device, stream);
}

}  // extern "C"
