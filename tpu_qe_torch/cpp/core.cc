// tpu_qe native core: deterministic data generation, extended-morton LUT
// construction, and bit-exact scalar oracles for the TPU sort/query engine.
//
// This is the C++ counterpart of the reference repo's Rust host-side compute
// (see /root/reference/src/main.rs:114-233 for scene + LUT glue and
// /root/reference/src/main.rs:923-1028 for the disabled CPU oracle, which is
// a live, enabled component here). Exposed through a plain C ABI and loaded
// from Python via ctypes (tpu_qe/native.py).
//
// Build: `make` in this directory -> libtpuqe.so
//
// IMPORTANT: compiled with -ffp-contract=off so float expressions evaluate
// with the exact same op-by-op rounding as the JAX/Pallas kernels (no FMA
// contraction), keeping morton quantization bit-exact across oracle/TPU.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

#if defined(_WIN32)
#define TQ_API extern "C" __declspec(dllexport)
#else
#define TQ_API extern "C" __attribute__((visibility("default")))
#endif

namespace {

// ---------------------------------------------------------------------------
// ChaCha8 stream, bit-compatible with Rust's rand_chacha::ChaCha8Rng as used
// by the reference (ChaCha8Rng::seed_from_u64, /root/reference/src/main.rs:124).
//
// rand_core's SeedableRng::seed_from_u64 expands the u64 seed into the 32-byte
// ChaCha key with a small PCG32 generator; ChaCha8Rng then produces 4 blocks
// (256 bytes) per round of the core, consumed as little-endian u32 words.
// ---------------------------------------------------------------------------

struct Pcg32Seeder {
  uint64_t state;
  explicit Pcg32Seeder(uint64_t seed) : state(seed) {}
  uint32_t next() {
    constexpr uint64_t MUL = 6364136223846793005ULL;
    constexpr uint64_t INC = 11634580027462260723ULL;
    state = state * MUL + INC;
    uint64_t s = state;
    uint32_t xorshifted = static_cast<uint32_t>(((s >> 18) ^ s) >> 27);
    uint32_t rot = static_cast<uint32_t>(s >> 59);
    return (xorshifted >> rot) | (xorshifted << ((32u - rot) & 31u));
  }
};

inline uint32_t rotl32(uint32_t x, int n) { return (x << n) | (x >> (32 - n)); }

struct ChaCha8 {
  // state words: 4 constants, 8 key words, 2 counter words (64-bit LE
  // counter), 2 stream words (zero). Matches rand_chacha's layout.
  uint32_t key[8];
  uint64_t counter;
  uint32_t buf[64];  // 4 blocks of 16 words, refilled together
  int pos;           // next word index in buf, 64 = empty

  explicit ChaCha8(uint64_t seed) : counter(0), pos(64) {
    Pcg32Seeder seeder(seed);
    uint8_t seed_bytes[32];
    for (int i = 0; i < 8; i++) {
      uint32_t w = seeder.next();
      std::memcpy(seed_bytes + 4 * i, &w, 4);
    }
    for (int i = 0; i < 8; i++) {
      std::memcpy(&key[i], seed_bytes + 4 * i, 4);
    }
  }

  void block(uint64_t ctr, uint32_t out[16]) {
    uint32_t x[16];
    x[0] = 0x61707865u; x[1] = 0x3320646eu; x[2] = 0x79622d32u; x[3] = 0x6b206574u;
    for (int i = 0; i < 8; i++) x[4 + i] = key[i];
    x[12] = static_cast<uint32_t>(ctr);
    x[13] = static_cast<uint32_t>(ctr >> 32);
    x[14] = 0; x[15] = 0;
    uint32_t w[16];
    std::memcpy(w, x, sizeof(w));
    auto qr = [&](int a, int b, int c, int d) {
      w[a] += w[b]; w[d] ^= w[a]; w[d] = rotl32(w[d], 16);
      w[c] += w[d]; w[b] ^= w[c]; w[b] = rotl32(w[b], 12);
      w[a] += w[b]; w[d] ^= w[a]; w[d] = rotl32(w[d], 8);
      w[c] += w[d]; w[b] ^= w[c]; w[b] = rotl32(w[b], 7);
    };
    for (int round = 0; round < 4; round++) {  // 8 rounds = 4 double-rounds
      qr(0, 4, 8, 12); qr(1, 5, 9, 13); qr(2, 6, 10, 14); qr(3, 7, 11, 15);
      qr(0, 5, 10, 15); qr(1, 6, 11, 12); qr(2, 7, 8, 13); qr(3, 4, 9, 14);
    }
    for (int i = 0; i < 16; i++) out[i] = w[i] + x[i];
  }

  void refill() {
    for (int b = 0; b < 4; b++) block(counter + b, buf + 16 * b);
    counter += 4;
    pos = 0;
  }

  uint32_t next_u32() {
    if (pos >= 64) refill();
    return buf[pos++];
  }

  // rand 0.8 Standard distribution for f32: 24 fraction bits in [0, 1).
  float next_f32() {
    uint32_t v = next_u32();
    return static_cast<float>(v >> 8) * (1.0f / 16777216.0f);
  }

  // rand 0.8 UniformInt<u32>::new(0, n) widening-multiply rejection sampling.
  uint32_t next_uniform_u32(uint32_t n) {
    if (n == 0) return 0;  // guard: % 0 is SIGFPE (kills the process)
    uint64_t range = n;
    uint64_t ints_to_reject = (0xFFFFFFFFull - range + 1) % range;
    uint64_t zone = 0xFFFFFFFFull - ints_to_reject;
    for (;;) {
      uint64_t v = next_u32();
      uint64_t prod = v * range;
      uint32_t hi = static_cast<uint32_t>(prod >> 32);
      uint32_t lo = static_cast<uint32_t>(prod);
      if (lo <= zone) return hi;
    }
  }
};

// ---------------------------------------------------------------------------
// Extended morton code (Vinkler-style: interleaved centroid xyz bits plus
// triangle-size bits). The reference consumes the crates.io
// `extended_morton_coder` crate purely through 4 observable artifacts
// (/root/reference/src/main.rs:175-198): a 9x256 u64 coordinate LUT, a 4096
// u64 size LUT, and per-axis offset/multiplier (+ scalar size_multiplier).
// We define our own bit layout with those exact LUT shapes and validate the
// LUT path against direct bit interleaving (resolving reference quirk
// morton_code.wgsl:72-74, which shifts by i*3 where the layout implies i*8).
//
// Layout (bit 63 = MSB): 4 super-levels, each = 5 levels of (x,y,z) + 1 size
// bit. Coordinate level l in [0,20) (0 = most significant), axis a in {0,1,2}:
//   bit position = 63 - ((l/5)*16 + (l%5)*3 + a)
// Size bit s in [0,4) (3 = most significant): position = 16*s.
// Coordinates quantized to 20 bits, size index to 12 bits (top 4 used).
// ---------------------------------------------------------------------------

constexpr int kCoordBits = 20;
constexpr int kSizeBits = 4;
constexpr int kSizeIndexBits = 12;
constexpr uint32_t kCoordMax = (1u << kCoordBits) - 1;
constexpr uint32_t kSizeIndexMax = (1u << kSizeIndexBits) - 1;

inline int coord_bit_position(int level, int axis) {
  // level 0 = most significant coordinate level.
  return 63 - ((level / 5) * 16 + (level % 5) * 3 + axis);
}

inline int size_bit_position(int bit) {  // bit 0 = LSB of the 4-bit size index
  return 16 * bit;
}

uint64_t spread_coord(uint32_t q, int axis) {
  uint64_t out = 0;
  for (int level = 0; level < kCoordBits; level++) {
    int src_bit = kCoordBits - 1 - level;  // level 0 <- MSB of q
    if ((q >> src_bit) & 1u) out |= 1ull << coord_bit_position(level, axis);
  }
  return out;
}

uint64_t spread_size(uint32_t s) {
  uint64_t out = 0;
  for (int b = 0; b < kSizeBits; b++) {
    if ((s >> b) & 1u) out |= 1ull << size_bit_position(b);
  }
  return out;
}

struct MortonGen {
  uint64_t lut[9][256];      // [axis + 3*byte_level][byte] -> spread bits
  uint64_t size_lut[4096];   // [12-bit size index] -> spread bits
  float morton_index_scale;  // parity field (unused by kernels), = 2^20
  float offset[3];
  float size_multiplier;
  float multiplier[3];
};

void morton_gen_init(const float smin[3], const float smax[3], MortonGen* g) {
  for (int a = 0; a < 3; a++) {
    g->offset[a] = smin[a];
    float extent = smax[a] - smin[a];
    g->multiplier[a] =
        extent > 0.0f ? static_cast<float>(1u << kCoordBits) / extent : 0.0f;
  }
  float dx = smax[0] - smin[0], dy = smax[1] - smin[1], dz = smax[2] - smin[2];
  float diag = std::sqrt(dx * dx + dy * dy + dz * dz);
  g->size_multiplier =
      diag > 0.0f ? static_cast<float>(kSizeIndexMax) / diag : 0.0f;
  g->morton_index_scale = static_cast<float>(1u << kCoordBits);
  for (int level = 0; level < 3; level++) {
    for (int axis = 0; axis < 3; axis++) {
      for (int byte = 0; byte < 256; byte++) {
        // byte `level` covers coordinate bits [8*level, 8*level+8)
        uint64_t v = 0;
        for (int b = 0; b < 8; b++) {
          int cb = 8 * level + b;  // coordinate bit index, 0 = LSB
          if (cb >= kCoordBits) continue;
          if ((byte >> b) & 1) {
            int l = kCoordBits - 1 - cb;
            v |= 1ull << coord_bit_position(l, axis);
          }
        }
        g->lut[axis + 3 * level][byte] = v;
      }
    }
  }
  for (uint32_t j = 0; j < 4096; j++) {
    g->size_lut[j] = spread_size(j >> (kSizeIndexBits - kSizeBits));
  }
}

// Quantize one centroid coordinate. Op-for-op identical to the float
// expression in the reference kernel (morton_code.wgsl:109):
//   u32(((min + max) * 0.5 - offset) * multiplier - 0.001)
// with WGSL's clamping float->u32 conversion, clamped to the 20-bit range.
inline uint32_t quantize_coord(float lo, float hi, float offset, float mult) {
  float c = (lo + hi) * 0.5f;
  float v = (c - offset) * mult - 0.001f;
  if (!(v > 0.0f)) return 0;  // also catches NaN
  if (v >= static_cast<float>(kCoordMax)) return kCoordMax;
  return static_cast<uint32_t>(v);
}

inline uint32_t quantize_size(float ex, float ey, float ez, float mult) {
  float len = std::sqrt(ex * ex + ey * ey + ez * ez);
  float v = len * mult;
  if (!(v > 0.0f)) return 0;
  if (v >= static_cast<float>(kSizeIndexMax)) return kSizeIndexMax;
  return static_cast<uint32_t>(v);
}

uint64_t encode_one_lut(const MortonGen* g, uint32_t qx, uint32_t qy,
                        uint32_t qz, uint32_t j) {
  uint64_t code = 0;
  uint32_t q[3] = {qx, qy, qz};
  for (int level = 0; level < 3; level++) {
    for (int axis = 0; axis < 3; axis++) {
      code |= g->lut[axis + 3 * level][(q[axis] >> (8 * level)) & 0xFF];
    }
  }
  code |= g->size_lut[j & kSizeIndexMax];
  return code;
}

// QUIRK-FAITHFUL consumption of the shipped reference kernel
// (morton_code.wgsl:72-74,111-126): byte-level i reads coordinate bits
// [3*i, 3*i+8) — the i*3 shift where the 9-group LUT layout implies i*8 —
// so only bits 0..13 of each quantized coordinate reach the key and
// byte windows overlap. Given identical LUT content this reproduces the
// shipped binary's morton codes exactly; it exists so `dump --quirk-lut`
// can byte-match the reference's observable behavior even though the
// crate's own LUT bit layout is unreachable from this environment.
uint64_t encode_one_lut_quirk(const MortonGen* g, uint32_t qx, uint32_t qy,
                              uint32_t qz, uint32_t j) {
  uint64_t code = 0;
  uint32_t q[3] = {qx, qy, qz};
  for (int level = 0; level < 3; level++) {
    for (int axis = 0; axis < 3; axis++) {
      code |= g->lut[axis + 3 * level][(q[axis] >> (3 * level)) & 0xFF];
    }
  }
  code |= g->size_lut[j & kSizeIndexMax];
  return code;
}

uint64_t encode_one_direct(uint32_t qx, uint32_t qy, uint32_t qz, uint32_t j) {
  return spread_coord(qx, 0) | spread_coord(qy, 1) | spread_coord(qz, 2) |
         spread_size(j >> (kSizeIndexBits - kSizeBits));
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

TQ_API void tq_chacha8_fill_u32(uint64_t seed, uint64_t n, uint32_t* out) {
  ChaCha8 rng(seed);
  for (uint64_t i = 0; i < n; i++) out[i] = rng.next_u32();
}

// Raw single ChaCha8 block with an explicit 32-byte key and 64-bit counter,
// exported so tests can check against the published ChaCha8 keystream vector.
TQ_API void tq_chacha8_raw_block(const uint8_t* key32, uint64_t counter,
                                 uint32_t* out16) {
  ChaCha8 rng(0);
  for (int i = 0; i < 8; i++) std::memcpy(&rng.key[i], key32 + 4 * i, 4);
  rng.block(counter, out16);
}

TQ_API void tq_chacha8_fill_f32(uint64_t seed, uint64_t n, float* out) {
  ChaCha8 rng(seed);
  for (uint64_t i = 0; i < n; i++) out[i] = rng.next_f32();
}

// Scene generation replicating the reference create_scene
// (/root/reference/src/main.rs:114-173): num_vertices random positions in
// [0,1)^3 (normal (0,1,0), uv (0,0.5) implicit), num_triangles uniform index
// triples; AABB accumulated over *used* vertices only.
TQ_API void tq_scene_generate(uint32_t num_vertices, uint32_t num_triangles,
                              uint64_t seed, float* verts /*V*3*/,
                              uint32_t* tris /*T*3*/, float* scene_min /*3*/,
                              float* scene_max /*3*/) {
  ChaCha8 rng(seed);
  for (uint32_t i = 0; i < num_vertices; i++) {
    verts[3 * i + 0] = rng.next_f32();
    verts[3 * i + 1] = rng.next_f32();
    verts[3 * i + 2] = rng.next_f32();
  }
  float mn[3] = {3.402823466e+38f, 3.402823466e+38f, 3.402823466e+38f};
  float mx[3] = {-3.402823466e+38f, -3.402823466e+38f, -3.402823466e+38f};
  for (uint32_t t = 0; t < num_triangles; t++) {
    for (int k = 0; k < 3; k++) {
      uint32_t idx = rng.next_uniform_u32(num_vertices);
      tris[3 * t + k] = idx;
      for (int a = 0; a < 3; a++) {
        float p = verts[3 * idx + a];
        if (p < mn[a]) mn[a] = p;
        if (p > mx[a]) mx[a] = p;
      }
    }
  }
  for (int a = 0; a < 3; a++) {
    scene_min[a] = mn[a];
    scene_max[a] = mx[a];
  }
}

TQ_API uint64_t tq_morton_gen_sizeof() { return sizeof(MortonGen); }

TQ_API void tq_morton_gen_init(const float* scene_min, const float* scene_max,
                               void* gen) {
  morton_gen_init(scene_min, scene_max, reinterpret_cast<MortonGen*>(gen));
}

// Flatten the generator to the exact GPU-visible layout of the reference
// (create_morton_uniforms, /root/reference/src/main.rs:177-198):
// lut -> 4608 u32 (each u64 as lo,hi), size_lut -> 8192 u32 (lo,hi),
// then morton_index_scale, offset[3], size_multiplier, multiplier[3] floats.
TQ_API void tq_morton_gen_flatten(const void* gen, uint32_t* lut4608,
                                  uint32_t* size_lut8192, float* scalars8) {
  const MortonGen* g = reinterpret_cast<const MortonGen*>(gen);
  int k = 0;
  for (int grp = 0; grp < 9; grp++) {
    for (int byte = 0; byte < 256; byte++) {
      uint64_t v = g->lut[grp][byte];
      lut4608[k++] = static_cast<uint32_t>(v);
      lut4608[k++] = static_cast<uint32_t>(v >> 32);
    }
  }
  for (int j = 0; j < 4096; j++) {
    size_lut8192[2 * j] = static_cast<uint32_t>(g->size_lut[j]);
    size_lut8192[2 * j + 1] = static_cast<uint32_t>(g->size_lut[j] >> 32);
  }
  scalars8[0] = g->morton_index_scale;
  scalars8[1] = g->offset[0];
  scalars8[2] = g->offset[1];
  scalars8[3] = g->offset[2];
  scalars8[4] = g->size_multiplier;
  scalars8[5] = g->multiplier[0];
  scalars8[6] = g->multiplier[1];
  scalars8[7] = g->multiplier[2];
}

// Quantize triangle centroids + sizes (the float part of morton coding),
// exposed separately so tests can isolate float-quantization parity from
// integer LUT parity.
TQ_API void tq_morton_quantize(const void* gen, const float* verts,
                               const uint32_t* tris, uint64_t num_tris,
                               uint32_t* q /* T*4: qx qy qz j */) {
  const MortonGen* g = reinterpret_cast<const MortonGen*>(gen);
  for (uint64_t t = 0; t < num_tris; t++) {
    const float* v0 = verts + 3 * tris[3 * t + 0];
    const float* v1 = verts + 3 * tris[3 * t + 1];
    const float* v2 = verts + 3 * tris[3 * t + 2];
    float mn[3], mx[3];
    for (int a = 0; a < 3; a++) {
      mn[a] = std::min(std::min(v0[a], v1[a]), v2[a]);
      mx[a] = std::max(std::max(v0[a], v1[a]), v2[a]);
    }
    for (int a = 0; a < 3; a++) {
      q[4 * t + a] = quantize_coord(mn[a], mx[a], g->offset[a], g->multiplier[a]);
    }
    q[4 * t + 3] = quantize_size(mx[0] - mn[0], mx[1] - mn[1], mx[2] - mn[2],
                                 g->size_multiplier);
  }
}

TQ_API void tq_morton_encode(const void* gen, const float* verts,
                             const uint32_t* tris, uint64_t num_tris,
                             uint64_t* codes) {
  const MortonGen* g = reinterpret_cast<const MortonGen*>(gen);
  std::vector<uint32_t> q(num_tris * 4);
  tq_morton_quantize(gen, verts, tris, num_tris, q.data());
  for (uint64_t t = 0; t < num_tris; t++) {
    codes[t] = encode_one_lut(g, q[4 * t], q[4 * t + 1], q[4 * t + 2],
                              q[4 * t + 3]);
  }
}

TQ_API void tq_morton_encode_quirk(const void* gen, const float* verts,
                                   const uint32_t* tris, uint64_t num_tris,
                                   uint64_t* codes) {
  const MortonGen* g = reinterpret_cast<const MortonGen*>(gen);
  std::vector<uint32_t> q(num_tris * 4);
  tq_morton_quantize(gen, verts, tris, num_tris, q.data());
  for (uint64_t t = 0; t < num_tris; t++) {
    codes[t] = encode_one_lut_quirk(g, q[4 * t], q[4 * t + 1], q[4 * t + 2],
                                    q[4 * t + 3]);
  }
}

// Direct (LUT-free) bit-interleave path; must agree with tq_morton_encode.
TQ_API void tq_morton_encode_direct(const uint32_t* q /* T*4 */,
                                    uint64_t num_tris, uint64_t* codes) {
  for (uint64_t t = 0; t < num_tris; t++) {
    codes[t] = encode_one_direct(q[4 * t], q[4 * t + 1], q[4 * t + 2],
                                 q[4 * t + 3]);
  }
}

// 8-bit digit extraction from a u64 split as (lo, hi) u32 — semantics of
// select_digit_8 (/root/reference/src/tests.rs:17-24, used by the histogram
// kernel radix_sort_histogram.wgsl:28-36).
TQ_API uint32_t tq_select_digit8(uint32_t pass, uint32_t lo, uint32_t hi) {
  if (pass <= 3) return (lo >> (pass * 8)) & 255u;
  return (hi >> ((pass - 4) * 8)) & 255u;
}

// 6-bit/11-pass variant kept for test parity (/root/reference/src/tests.rs:7-15).
TQ_API uint32_t tq_select_digit6(uint32_t pass, uint32_t lo, uint32_t hi) {
  if (pass <= 4) return (lo >> (pass * 6)) & 63u;
  if (pass == 5) return ((lo >> 30) & 3u) | ((hi & 15u) << 2);
  return (hi >> ((pass - 6) * 6 + 4)) & 63u;
}

// Stable LSD radix sort oracle over u64 keys + u32 payload, configurable
// digit width. This is the live version of the reference's disabled CPU
// re-derivation oracle (/root/reference/src/main.rs:923-1028).
TQ_API void tq_lsd_sort(uint64_t* keys, uint32_t* payload, uint64_t n,
                        uint32_t bits_per_pass, uint32_t num_passes) {
  uint32_t radix = 1u << bits_per_pass;
  std::vector<uint64_t> keys2(n);
  std::vector<uint32_t> pay2(n);
  std::vector<uint64_t> hist(radix);
  uint64_t* src_k = keys;
  uint64_t* dst_k = keys2.data();
  uint32_t* src_p = payload;
  uint32_t* dst_p = pay2.data();
  for (uint32_t pass = 0; pass < num_passes; pass++) {
    uint32_t shift = pass * bits_per_pass;
    std::fill(hist.begin(), hist.end(), 0);
    for (uint64_t i = 0; i < n; i++) {
      hist[(src_k[i] >> shift) & (radix - 1)]++;
    }
    uint64_t sum = 0;
    for (uint32_t d = 0; d < radix; d++) {
      uint64_t c = hist[d];
      hist[d] = sum;
      sum += c;
    }
    for (uint64_t i = 0; i < n; i++) {
      uint32_t d = (src_k[i] >> shift) & (radix - 1);
      uint64_t dst = hist[d]++;
      dst_k[dst] = src_k[i];
      if (payload) dst_p[dst] = src_p[i];
    }
    std::swap(src_k, dst_k);
    std::swap(src_p, dst_p);
  }
  if (src_k != keys) {
    std::memcpy(keys, src_k, n * sizeof(uint64_t));
    if (payload) std::memcpy(payload, src_p, n * sizeof(uint32_t));
  }
}

// Per-block digit histogram in the digit-major global layout of the
// reference (radix_sort_histogram.wgsl:58-59): hist[num_blocks * d + b] so a
// single flat exclusive scan yields every (digit, block) global base offset.
TQ_API void tq_digit_major_histogram(const uint64_t* keys, uint64_t n,
                                     uint32_t pass, uint32_t bits_per_pass,
                                     uint32_t block_size,
                                     uint32_t* hist /* radix*num_blocks */) {
  uint32_t radix = 1u << bits_per_pass;
  uint64_t num_blocks = (n + block_size - 1) / block_size;
  std::fill(hist, hist + radix * num_blocks, 0u);
  uint32_t shift = pass * bits_per_pass;
  for (uint64_t i = 0; i < n; i++) {
    uint32_t d = (keys[i] >> shift) & (radix - 1);
    hist[num_blocks * d + (i / block_size)]++;
  }
}

// Stable local rank oracle: occurrence index of each element among equal
// digits before it in the block. Counting-based equivalent of the ballot
// simulation in the reference CPU test (/root/reference/src/tests.rs:62-85).
TQ_API void tq_block_rank(const uint32_t* digits, uint64_t n, uint32_t radix,
                          uint32_t* local_offsets) {
  std::vector<uint32_t> count(radix, 0);
  for (uint64_t i = 0; i < n; i++) {
    local_offsets[i] = count[digits[i]]++;
  }
}

// Full final-location derivation for one pass, matching the documented
// contract of the reference oracle (/root/reference/src/main.rs:935-939):
// final location = (count of digits < d in ALL blocks) + (count of digit d in
// blocks before this one) + local stable rank.
TQ_API void tq_scatter_locations(const uint64_t* keys, uint64_t n,
                                 uint32_t pass, uint32_t bits_per_pass,
                                 uint32_t block_size, uint64_t* locations) {
  uint32_t radix = 1u << bits_per_pass;
  uint64_t num_blocks = (n + block_size - 1) / block_size;
  std::vector<uint32_t> hist(radix * num_blocks);
  tq_digit_major_histogram(keys, n, pass, bits_per_pass, block_size,
                           hist.data());
  // flat exclusive scan over the digit-major histogram
  std::vector<uint64_t> base(radix * num_blocks);
  uint64_t sum = 0;
  for (uint64_t i = 0; i < radix * num_blocks; i++) {
    base[i] = sum;
    sum += hist[i];
  }
  uint32_t shift = pass * bits_per_pass;
  std::vector<uint32_t> occ(radix);
  for (uint64_t b = 0; b < num_blocks; b++) {
    std::fill(occ.begin(), occ.end(), 0u);
    uint64_t end = std::min(n, (b + 1) * block_size);
    for (uint64_t i = b * block_size; i < end; i++) {
      uint32_t d = (keys[i] >> shift) & (radix - 1);
      locations[i] = base[num_blocks * d + b] + occ[d]++;
    }
  }
}

// Convenience end-to-end oracle: scene -> morton codes -> stable sort of
// (code, triangle index) pairs. Mirrors the reference's full pipeline
// (/root/reference/src/main.rs:376-688) on the CPU.
TQ_API void tq_pipeline_oracle(uint32_t num_vertices, uint32_t num_triangles,
                               uint64_t seed, uint64_t* sorted_codes,
                               uint32_t* sorted_indices) {
  std::vector<float> verts(num_vertices * 3);
  std::vector<uint32_t> tris(num_triangles * 3);
  float smin[3], smax[3];
  tq_scene_generate(num_vertices, num_triangles, seed, verts.data(),
                    tris.data(), smin, smax);
  MortonGen g;
  morton_gen_init(smin, smax, &g);
  tq_morton_encode(&g, verts.data(), tris.data(), num_triangles, sorted_codes);
  for (uint32_t i = 0; i < num_triangles; i++) sorted_indices[i] = i;
  tq_lsd_sort(sorted_codes, sorted_indices, num_triangles, 8, 8);
}
