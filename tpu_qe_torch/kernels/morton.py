"""Extended-morton keys on the card: B4 and the fused encode (csrc/morton.cu).

B4 (``encode_quantized_lut``) ports tpu_qe/kernels/morton.py::
encode_quantized_lut: the key of quantized cells as the OR of 9 LUT words,
one per (axis, level) group, indexed by byte ``(q[axis] >> step * level) &
0xFF`` (step 8, or 3 with ``quirk_shift``), plus the 4 size bits ``j >> 8``
placed directly at key bits 0, 16, 32 and 48. The direct placement equals
the 4096-entry size LUT of tpu_qe_torch.morton for every j. Any n is taken
(the JAX kernel needed multiples of 1024); the kernel masks the tail.

The fused encode (``encode_triangles``, ``encode_points``) is the port's
own kernel: vertex gather, quantization and the direct bit interleave of
tpu_qe_torch.morton in one pass, for triangles or for columnar points. Its
plain twin is tpu_qe_torch.morton's ``quantize`` (or ``quantize_points``)
and ``encode_quantized``; the kernel keeps their float order without FMA
contraction, so the keys are bit-exact.
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


def _check_uniforms(params, dev: torch.device) -> None:
    for name, shape in (("offset", (3,)), ("multiplier", (3,)),
                        ("size_multiplier", ())):
        t = getattr(params, name)
        if t.shape != shape or t.dtype != torch.float32 or \
                not t.is_contiguous() or t.device != dev:
            raise ValueError(f"params.{name} must be a contiguous float32 "
                             f"{shape} tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _check_device(dev: torch.device) -> None:
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def encode_triangles_plain(verts: torch.Tensor, tris: torch.Tensor,
                           params) -> U64:
    """Plain twin of the fused encode: quantize, then interleave."""
    from tpu_qe_torch import morton
    return morton.encode_quantized(*morton.quantize(verts, tris, params))


def encode_triangles(verts: torch.Tensor, tris: torch.Tensor, params) -> U64:
    """Morton keys of a triangle scene by the fused kernel.

    verts (V, 3) float32 and tris (T, 3) int32 or int64, contiguous, on one
    device with params' offset, multiplier and size_multiplier (a
    tpu_qe_torch.morton.MortonParams). Every index must lie in [0, V): the
    kernel reads what it is given, and checking would read the device.
    Returns U64 keys on that device; T = 0 launches nothing.
    """
    dev = verts.device
    if verts.dim() != 2 or verts.shape[1] != 3 or \
            verts.dtype != torch.float32:
        raise ValueError(f"verts must be (V, 3) float32, got {verts.dtype} "
                         f"{tuple(verts.shape)}")
    if tris.dim() != 2 or tris.shape[1] != 3 or \
            tris.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"tris must be (T, 3) int32 or int64, got "
                         f"{tris.dtype} {tuple(tris.shape)}")
    if not (verts.is_contiguous() and tris.is_contiguous()):
        raise ValueError("verts and tris must be contiguous")
    if tris.device != dev:
        raise ValueError("verts and tris differ in device")
    _check_device(dev)
    _check_uniforms(params, dev)
    if dev.type == "cpu":
        return encode_triangles_plain(verts, tris, params)
    n = tris.shape[0]
    lo = torch.empty(n, dtype=torch.int32, device=dev)
    hi = torch.empty_like(lo)
    if n == 0:
        return U64(lo, hi)
    lib = library()
    check(lib, lib.tq_morton_encode_triangles(
        verts.data_ptr(), tris.data_ptr(), tris.element_size(), n,
        params.offset.data_ptr(), params.multiplier.data_ptr(),
        params.size_multiplier.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        dev.index, stream_of(verts)), "encode_triangles")
    LAUNCHES["encode_triangles"] += 1
    return U64(lo, hi)


def encode_points_plain(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                        size: torch.Tensor | None, params) -> U64:
    """Plain twin of the fused encode of columnar points."""
    from tpu_qe_torch import morton
    return morton.encode_quantized(*morton.quantize_points(x, y, z, size,
                                                           params))


def encode_points(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                  size: torch.Tensor | None, params) -> U64:
    """Morton keys of columnar points by the fused kernel.

    x, y, z and size (or None: every size index 0) are contiguous (n,)
    float32 columns on one device with params' uniforms. Returns U64 keys
    on that device; n = 0 launches nothing.
    """
    cols = [x, y, z] + ([] if size is None else [size])
    dev, n = x.device, x.shape[0] if x.dim() == 1 else -1
    for t in cols:
        if t.dim() != 1 or t.shape[0] != n or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError("expected contiguous (n,) float32 columns, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError("the columns differ in device")
    _check_device(dev)
    _check_uniforms(params, dev)
    if dev.type == "cpu":
        return encode_points_plain(x, y, z, size, params)
    lo = torch.empty(n, dtype=torch.int32, device=dev)
    hi = torch.empty_like(lo)
    if n == 0:
        return U64(lo, hi)
    lib = library()
    check(lib, lib.tq_morton_encode_points(
        x.data_ptr(), y.data_ptr(), z.data_ptr(),
        None if size is None else size.data_ptr(), n,
        params.offset.data_ptr(), params.multiplier.data_ptr(),
        params.size_multiplier.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        dev.index, stream_of(x)), "encode_points")
    LAUNCHES["encode_points"] += 1
    return U64(lo, hi)
