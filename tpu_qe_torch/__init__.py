"""tpu_qe_torch — the tpu_qe morton-key radix-sort engine on PyTorch + CUDA.

The port of the JAX package ``tpu_qe`` (which stays the reference) to one
NVIDIA Hopper GPU. Plain tensor code is PyTorch; each Pallas kernel of the
reference on this path is a hand-written CUDA kernel under ``csrc/``, with
a plain PyTorch twin that runs on CPU tensors:

- ``tpu_qe_torch.native``   — ctypes binding of the shared C++ core
  (scene generation, morton LUTs, CPU oracles)
- ``tpu_qe_torch.bits``     — u64 keys as (lo, hi) int32 planes, digits
- ``tpu_qe_torch.morton``   — morton encoding
- ``tpu_qe_torch.kernels``  — CUDA histogram, scan and rank/scatter kernels
- ``tpu_qe_torch.sort``     — multi-pass LSD radix sort driver
- ``tpu_qe_torch.pipeline`` — scene -> morton codes -> sorted index
- ``tpu_qe_torch.bench``    — speed-of-light model + headline benchmark

Nothing here imports JAX or ``tpu_qe``.
"""

__version__ = "0.1.0"
