"""Extended-morton key from quantized cells through the LUT words (B4).

Port of tpu_qe/kernels/morton.py::encode_quantized_lut as a CUDA kernel in
csrc/morton.cu: the OR of 9 LUT words, one per (axis, level) group, indexed
by byte ``(q[axis] >> step * level) & 0xFF`` (step 8, or 3 with
``quirk_shift``), plus the 4 size bits ``j >> 8`` placed directly at key
bits 0, 16, 32 and 48. The direct placement equals the 4096-entry size LUT
of tpu_qe_torch.morton for every j. Any n is taken (the JAX kernel needed
multiples of 1024); the kernel masks the tail.
"""

from __future__ import annotations

import torch

from tpu_qe_torch.bits import U64
from tpu_qe_torch.constants import SIZE_BITS, SIZE_INDEX_BITS
from tpu_qe_torch.kernels import LAUNCHES, check, library, stream_of

LUT_GROUPS = 9


def _step(quirk_shift: bool) -> int:
    return 3 if quirk_shift else 8


def _check_args(q: torch.Tensor, j: torch.Tensor, lut_lo: torch.Tensor,
                lut_hi: torch.Tensor) -> torch.device:
    n = q.shape[0] if q.dim() == 2 else -1
    if q.dim() != 2 or q.shape[1] != 3 or j.shape != (n,):
        raise ValueError(f"expected q (n, 3) and j (n,), got "
                         f"{tuple(q.shape)} and {tuple(j.shape)}")
    for name, t in (("lut_lo", lut_lo), ("lut_hi", lut_hi)):
        if t.shape != (LUT_GROUPS, 256):
            raise ValueError(f"{name} must be (9, 256), got {tuple(t.shape)}")
    for t in (q, j, lut_lo, lut_hi):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("expected contiguous int32 tensors, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError("q, j and the LUTs differ in device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return q.device


def encode_quantized_lut_plain(q: torch.Tensor, j: torch.Tensor,
                               lut_lo: torch.Tensor, lut_hi: torch.Tensor,
                               quirk_shift: bool = False) -> U64:
    """Plain twin of B4: the same gathers and direct size bits in torch."""
    lo = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    hi = torch.zeros_like(lo)
    step = _step(quirk_shift)
    for level in range(3):
        for axis in range(3):
            byte = ((q[:, axis] >> (step * level)) & 0xFF).to(torch.int64)
            grp = axis + 3 * level
            lo = lo | lut_lo[grp][byte]
            hi = hi | lut_hi[grp][byte]
    s = j >> (SIZE_INDEX_BITS - SIZE_BITS)
    for b in range(SIZE_BITS):
        bit = (s >> b) & 1
        pos = 16 * b                 # tpu_qe_torch.morton.size_bit_position
        if pos < 32:
            lo = lo | (bit << pos)
        else:
            hi = hi | (bit << (pos - 32))
    return U64(lo, hi)


def encode_quantized_lut(q: torch.Tensor, j: torch.Tensor,
                         lut_lo: torch.Tensor, lut_hi: torch.Tensor,
                         quirk_shift: bool = False) -> U64:
    """Morton keys of quantized cells (B4).

    q (n, 3) and j (n,) int32 hold u32 cell coordinates and size indices;
    lut_lo/lut_hi are the (9, 256) int32 LUT words (MortonParams.lut_lo/hi).
    Returns U64 keys on q's device.
    """
    dev = _check_args(q, j, lut_lo, lut_hi)
    if dev.type == "cpu":
        return encode_quantized_lut_plain(q, j, lut_lo, lut_hi, quirk_shift)
    n = q.shape[0]
    lo = torch.empty(n, dtype=torch.int32, device=dev)
    hi = torch.empty_like(lo)
    lib = library()
    check(lib, lib.tq_morton_encode_lut(
        q.data_ptr(), j.data_ptr(), lut_lo.data_ptr(), lut_hi.data_ptr(), n,
        _step(quirk_shift), lo.data_ptr(), hi.data_ptr(), dev.index,
        stream_of(q)), "encode_quantized_lut")
    LAUNCHES["encode_quantized_lut"] += 1
    return U64(lo, hi)
