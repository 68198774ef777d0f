"""Engine constants.

The reference's compile-time configuration (mirrored from tpu_qe.constants,
which this package does not import) plus the port's own sort block size.
Runtime problem sizes are configurable (tpu_qe_torch.config.SortConfig).
"""

# Reference-parity scene defaults
NUM_VERTICES = 1000
NUM_TRIANGLES = 3000
RNG_SEED = 7

# Radix configuration
BITS_PER_PASS = 8
NUM_PASSES = 8                      # 8 x 8 bits = full 64-bit key

# Morton code layout (tpu_qe/cpp/core.cc)
COORD_BITS = 20
SIZE_BITS = 4
SIZE_INDEX_BITS = 12

# Keys per CUDA block in the radix kernels. A block of 256 threads walks
# its 4096 keys in 16 tiles of 256, so a 2^24-key pass launches 4096 blocks,
# some 31 per SM of an H100: enough to hide HBM latency. The rank kernel's
# shared state is about 9 KB, so 8 such blocks (2048 threads, the SM's
# limit) fit on one SM. The digit-major histogram costs radix * n / 4096
# words per pass: for 8-bit digits a quarter of a byte per key, against the
# 32 bytes per key that the pass must move.
BLOCK = 4096
