"""tpu_qe_torch — the tpu_qe morton-key radix-sort engine on PyTorch + CUDA.

The port of the JAX package ``tpu_qe`` (which stays the reference) to one
NVIDIA Hopper GPU. Plain tensor code is PyTorch; each of the reference's
six Pallas kernels is a hand-written CUDA kernel under ``csrc/``, with a
plain PyTorch twin that runs on CPU tensors:

- ``tpu_qe_torch.native``   — ctypes binding of the shared C++ core
  (scene generation, morton LUTs, CPU oracles)
- ``tpu_qe_torch.bits``     — u64 keys as (lo, hi) int32 planes, digits
- ``tpu_qe_torch.morton``   — morton encoding
- ``tpu_qe_torch.kernels``  — CUDA histogram, scan and rank/scatter (B1-B3),
  morton LUT encode (B4), bitonic chunk sort (B5) and tensor-core rank (B6)
- ``tpu_qe_torch.sort``     — multi-pass LSD radix sort driver
- ``tpu_qe_torch.pipeline`` — scene -> morton codes -> sorted index
- ``tpu_qe_torch.bench``    — speed-of-light model, headline benchmark and
  per-kernel benchmark
- ``tpu_qe_torch.selfcheck`` — every kernel on the card against its oracle

Nothing here imports JAX or ``tpu_qe``.
"""

__version__ = "0.1.0"
