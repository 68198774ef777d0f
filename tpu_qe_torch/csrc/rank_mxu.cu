// Stable in-block rank and digit-major histogram of 8-bit digits, counted
// on the tensor cores through nibble one-hot matrix products (B6).
//
// Replaces tpu_qe/kernels/rank_mxu.py::block_rank_and_histogram_mxu; its
// output equals B3's rank mode (csrc/radix.cu) bit for bit. Per row of 128
// keys, with each digit split into its high and low nibble and one-hot
// rows OH_hi, OH_lo (128 x 16, 0/1 in fp16):
//
//   SAME = (OH_hi OH_hi^T) * (OH_lo OH_lo^T)   SAME[i][j] = [d_i == d_j]
//   rank_in_row[i] = sum_{j<i} SAME[i][j]
//   H = OH_hi^T OH_lo                          the row's 16 x 16 histogram
//
// SAME and H run as mma.sync m16n8k16 (fp16 in, f32 accumulate): their
// values are at most 128, so they are exact. The base of a key, the count
// of its digit in the earlier rows of the block, reaches the block size
// (4096 by default), which fp16 and tf32 hold exactly only to 2048 and
// bf16 to 256. So it never passes through a tensor-core operand: it is an
// exact u32 lookup in shared memory, the cheap gather that the TPU kernel's
// dual matmul stood in for.
//
// One CUDA block per key block, one warp per row, 8 rows at a time: the
// warps' row histograms are scanned per digit over the warps on top of a
// running count, as in B3. Bound by the 160 mma instructions per
// 128 keys (only the SAME tiles below the diagonal are computed) and the
// fragment construction from shared memory; HBM moves 12 bytes per key.
// A ragged tail is masked: a masked key's nibbles match no one-hot column.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRow = 128;
constexpr int kRadix = 256;
constexpr uint8_t kNone = 16;

static_assert(kThreads == kRadix, "one thread per digit in the warp scan");

__device__ __forceinline__ uint32_t digit8(uint32_t lo, uint32_t hi,
                                           int shift) {
  if (shift + 8 <= 32) return (lo >> shift) & 0xFFu;
  if (shift >= 32) return (hi >> (shift - 32)) & 0xFFu;
  return ((lo >> shift) | (hi << (32 - shift))) & 0xFFu;
}

// Two fp16 values, 1.0 or 0.0, packed as one .f16x2 register (x low).
__device__ __forceinline__ uint32_t ones(bool x, bool y) {
  return (x ? 0x3C00u : 0u) | (y ? 0x3C000000u : 0u);
}

// acc += A (16 x 16, row) * B (16 x 8, col), fp16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float (&acc)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of the one-hot matrix OH[r][c] = [nib[r] == c], rows r0..r0+15
// (lane's rows: r0 + g and r0 + g + 8; columns 2t, 2t+1, 2t+8, 2t+9).
__device__ __forceinline__ void onehot_a(uint32_t (&a)[4], const uint8_t* nib,
                                         int r0, int g, int t) {
  const int x = nib[r0 + g], y = nib[r0 + g + 8], c = 2 * t;
  a[0] = ones(x == c, x == c + 1);
  a[1] = ones(y == c, y == c + 1);
  a[2] = ones(x == c + 8, x == c + 9);
  a[3] = ones(y == c + 8, y == c + 9);
}

// B fragment of OH^T restricted to keys j0..j0+7: B[k][n] = [nib[j0+n] == k]
// (lane's column n = g; rows 2t, 2t+1, 2t+8, 2t+9).
__device__ __forceinline__ void onehot_b(uint32_t (&b)[2], const uint8_t* nib,
                                         int j0, int g, int t) {
  const int x = nib[j0 + g], c = 2 * t;
  b[0] = ones(x == c, x == c + 1);
  b[1] = ones(x == c + 8, x == c + 9);
}

__global__ void __launch_bounds__(kThreads)
rank_mxu_kernel(const uint32_t* __restrict__ lo,
                const uint32_t* __restrict__ hi, int64_t n, int64_t block,
                int64_t nb, int shift, uint32_t* __restrict__ ranks,
                uint32_t* __restrict__ hist) {
  __shared__ uint8_t nib_hi[kWarps][kRow];
  __shared__ uint8_t nib_lo[kWarps][kRow];
  __shared__ uint32_t row_rank[kWarps][kRow];
  __shared__ uint32_t counts[kWarps][kRadix];  // row histogram, then base
  __shared__ uint32_t running[kRadix];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;   // mma group and thread in group
  const int64_t b = blockIdx.x;
  const int64_t start = b * block;
  const int64_t end = start + block < n ? start + block : n;
  const int64_t rows = (end - start + kRow - 1) / kRow;
  const uint8_t* nh = nib_hi[warp];
  const uint8_t* nl = nib_lo[warp];
  running[tid] = 0u;

  for (int64_t r0 = 0; r0 < rows; r0 += kWarps) {
    const int64_t row_start = start + (r0 + warp) * kRow;
    for (int e = lane; e < kRow; e += 32) {
      const int64_t gi = row_start + e;
      uint8_t h = kNone, l = kNone;
      if (gi < end) {
        const uint32_t d = digit8(lo[gi], hi[gi], shift);
        h = static_cast<uint8_t>(d >> 4);
        l = static_cast<uint8_t>(d & 15u);
      }
      nib_hi[warp][e] = h;
      nib_lo[warp][e] = l;
    }
    __syncwarp();

    // In-row ranks from SAME, m-tile by m-tile; n-tiles right of the
    // m-tile's last row hold no j < i and are skipped.
    for (int i0 = 0; i0 < kRow; i0 += 16) {
      uint32_t ah[4], al[4];
      onehot_a(ah, nh, i0, g, t);
      onehot_a(al, nl, i0, g, t);
      const int ra = i0 + g, rb = ra + 8;
      float acc_a = 0.f, acc_b = 0.f;
      for (int j0 = 0; j0 <= i0 + 8; j0 += 8) {
        uint32_t bh[2], bl[2];
        onehot_b(bh, nh, j0, g, t);
        onehot_b(bl, nl, j0, g, t);
        float sh[4] = {0.f, 0.f, 0.f, 0.f}, sl[4] = {0.f, 0.f, 0.f, 0.f};
        mma16816(sh, ah, bh);
        mma16816(sl, al, bl);
        const int c = j0 + 2 * t;   // this lane's columns: c, c + 1
        if (c < ra) acc_a += sh[0] * sl[0];
        if (c + 1 < ra) acc_a += sh[1] * sl[1];
        if (c < rb) acc_b += sh[2] * sl[2];
        if (c + 1 < rb) acc_b += sh[3] * sl[3];
      }
      acc_a += __shfl_xor_sync(0xFFFFFFFFu, acc_a, 1);
      acc_a += __shfl_xor_sync(0xFFFFFFFFu, acc_a, 2);
      acc_b += __shfl_xor_sync(0xFFFFFFFFu, acc_b, 1);
      acc_b += __shfl_xor_sync(0xFFFFFFFFu, acc_b, 2);
      if (t == 0) {
        row_rank[warp][ra] = static_cast<uint32_t>(acc_a);
        row_rank[warp][rb] = static_cast<uint32_t>(acc_b);
      }
    }

    // Row histogram H = OH_hi^T OH_lo: A[m][k] = [nh[k0+k] == m],
    // B[k][n] = [nl[k0+k] == n0+n], over 8 chunks of 16 keys.
    float h0[4] = {0.f, 0.f, 0.f, 0.f}, h1[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < kRow; k0 += 16) {
      const int c = k0 + 2 * t;
      const int x0 = nh[c], x1 = nh[c + 1], x8 = nh[c + 8], x9 = nh[c + 9];
      const uint32_t a[4] = {ones(x0 == g, x1 == g),
                             ones(x0 == g + 8, x1 == g + 8),
                             ones(x8 == g, x9 == g),
                             ones(x8 == g + 8, x9 == g + 8)};
      const int y0 = nl[c], y1 = nl[c + 1], y8 = nl[c + 8], y9 = nl[c + 9];
      const uint32_t b0[2] = {ones(y0 == g, y1 == g), ones(y8 == g, y9 == g)};
      const uint32_t b1[2] = {ones(y0 == g + 8, y1 == g + 8),
                              ones(y8 == g + 8, y9 == g + 8)};
      mma16816(h0, a, b0);
      mma16816(h1, a, b1);
    }
    // C fragment: [0] (g, 2t), [1] (g, 2t+1), [2] (g+8, 2t), [3] (g+8, 2t+1);
    // digit = 16 * high nibble (row) + low nibble (column)
    uint32_t* cw = counts[warp];
    const int d = 16 * g + 2 * t;
    cw[d] = static_cast<uint32_t>(h0[0]);
    cw[d + 1] = static_cast<uint32_t>(h0[1]);
    cw[d + 128] = static_cast<uint32_t>(h0[2]);
    cw[d + 129] = static_cast<uint32_t>(h0[3]);
    cw[d + 8] = static_cast<uint32_t>(h1[0]);
    cw[d + 9] = static_cast<uint32_t>(h1[1]);
    cw[d + 136] = static_cast<uint32_t>(h1[2]);
    cw[d + 137] = static_cast<uint32_t>(h1[3]);
    __syncthreads();

    // Exclusive scan of each digit's count over the warps (rows in input
    // order), on top of the running count of the earlier row groups.
    {
      uint32_t s = running[tid];
      for (int w = 0; w < kWarps; ++w) {
        const uint32_t cnt = counts[w][tid];
        counts[w][tid] = s;
        s += cnt;
      }
      running[tid] = s;
    }
    __syncthreads();

    for (int e = lane; e < kRow; e += 32) {
      const int64_t gi = row_start + e;
      if (gi < end) {
        ranks[gi] = cw[16 * nh[e] + nl[e]] + row_rank[warp][e];
      }
    }
    __syncthreads();   // nibbles, ranks and counts are rewritten next group
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
  rank_mxu_kernel<<<static_cast<unsigned>(nb), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      lo, hi, n, block, nb, shift, ranks, hist);
  return cudaGetLastError();
}

}  // extern "C"
