"""Extended-morton encoding (plain PyTorch).

Per triangle: gather the 3 vertices, take the AABB, quantize the centroid
to 20-bit cells and the AABB diagonal to a 12-bit size index, then build the
64-bit extended-morton key, either by direct bit interleave (the default,
as in the JAX main path) or through the reference's LUTs (9 groups x 256
bytes + a 4096-entry size LUT), with the shipped kernel's i*3 byte shift
when ``quirk_shift`` is set.

Float order must round like the -ffp-contract=off C++ oracle. Eager
PyTorch runs every op as its own kernel with its result stored in float32,
so nothing is contracted into an FMA; keep this module eager (no
torch.compile).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_qe_torch import native
from tpu_qe_torch.bits import U64, as_i32, narrow
from tpu_qe_torch.constants import COORD_BITS, SIZE_BITS, SIZE_INDEX_BITS

_COORD_MAX = (1 << COORD_BITS) - 1
_SIZE_INDEX_MAX = (1 << SIZE_INDEX_BITS) - 1


def coord_bit_position(level: int, axis: int) -> int:
    """Output bit (63=MSB) for coordinate level (0=most significant) + axis."""
    return 63 - ((level // 5) * 16 + (level % 5) * 3 + axis)


def size_bit_position(bit: int) -> int:
    return 16 * bit


class MortonParams(NamedTuple):
    """Morton uniforms and LUTs of a scene, as tensors on one device."""

    offset: torch.Tensor           # (3,) f32
    multiplier: torch.Tensor       # (3,) f32
    size_multiplier: torch.Tensor  # () f32
    lut_lo: torch.Tensor           # (9, 256) int32 (u32 bits)
    lut_hi: torch.Tensor           # (9, 256) int32
    size_lut_lo: torch.Tensor      # (4096,) int32
    size_lut_hi: torch.Tensor      # (4096,) int32

    @staticmethod
    def from_reference(arrays: dict[str, np.ndarray],
                       device: str | torch.device) -> "MortonParams":
        """Carry the JAX package's MortonParams fields, as numpy arrays
        keyed by field name, over to tensors on `device`."""
        def f32(a):
            return torch.from_numpy(
                np.array(a, dtype=np.float32)).to(device)

        def u32(a):
            return torch.from_numpy(as_i32(np.array(a, dtype=np.uint32))).to(
                device)

        return MortonParams(
            offset=f32(arrays["offset"]),
            multiplier=f32(arrays["multiplier"]),
            size_multiplier=f32(arrays["size_multiplier"]),
            lut_lo=u32(arrays["lut_lo"]), lut_hi=u32(arrays["lut_hi"]),
            size_lut_lo=u32(arrays["size_lut_lo"]),
            size_lut_hi=u32(arrays["size_lut_hi"]))

    @staticmethod
    def from_native(gen: native.MortonGen,
                    device: str | torch.device) -> "MortonParams":
        m = np.uint64(0xFFFFFFFF)
        return MortonParams.from_reference(dict(
            offset=gen.offset, multiplier=gen.multiplier,
            size_multiplier=gen.size_multiplier,
            lut_lo=(gen.lut & m).astype(np.uint32),
            lut_hi=(gen.lut >> np.uint64(32)).astype(np.uint32),
            size_lut_lo=(gen.size_lut & m).astype(np.uint32),
            size_lut_hi=(gen.size_lut >> np.uint64(32)).astype(np.uint32),
        ), device)

    @staticmethod
    def for_scene(scene_min, scene_max,
                  device: str | torch.device) -> "MortonParams":
        return MortonParams.from_native(
            native.MortonGen(np.asarray(scene_min), np.asarray(scene_max)),
            device)


def quantize(verts: torch.Tensor, tris: torch.Tensor,
             params: MortonParams) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize triangle centroids and sizes.

    Float op order: ``((min + max) * 0.5 - offset) * multiplier - 0.001``
    and ``sqrt(dx*dx + dy*dy + dz*dz) * size_multiplier``, clamped, then
    truncated.

    Args: verts (V, 3) f32; tris (T, 3) int32 or int64 vertex indices.
    Returns (q (T, 3) int32 cell coords, j (T,) int32 size index).
    """
    v0 = verts.index_select(0, tris[:, 0])
    v1 = verts.index_select(0, tris[:, 1])
    v2 = verts.index_select(0, tris[:, 2])
    mn = torch.minimum(torch.minimum(v0, v1), v2)
    mx = torch.maximum(torch.maximum(v0, v1), v2)
    half = torch.tensor(0.5, dtype=torch.float32, device=verts.device)
    eps = torch.tensor(0.001, dtype=torch.float32, device=verts.device)
    c = (mn + mx) * half
    prod = (c - params.offset) * params.multiplier
    val = prod - eps
    q = torch.clamp(val, 0.0, float(_COORD_MAX)).to(torch.int32)
    ext = mx - mn
    sq = ext * ext
    length = torch.sqrt(sq[:, 0] + sq[:, 1] + sq[:, 2])
    j = torch.clamp(length * params.size_multiplier, 0.0,
                    float(_SIZE_INDEX_MAX)).to(torch.int32)
    return q, j


def encode_quantized(q: torch.Tensor, j: torch.Tensor) -> U64:
    """Direct bit interleave: (T, 3) + (T,) int32 -> U64."""
    lo = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    hi = torch.zeros_like(lo)
    for axis in range(3):
        col = q[:, axis].to(torch.int64)
        for level in range(COORD_BITS):
            bit = (col >> (COORD_BITS - 1 - level)) & 1
            pos = coord_bit_position(level, axis)
            if pos < 32:
                lo |= bit << pos
            else:
                hi |= bit << (pos - 32)
    s = j.to(torch.int64) >> (SIZE_INDEX_BITS - SIZE_BITS)
    for b in range(SIZE_BITS):
        pos = size_bit_position(b)
        bit = (s >> b) & 1
        if pos < 32:
            lo |= bit << pos
        else:
            hi |= bit << (pos - 32)
    return U64(narrow(lo), narrow(hi))


def encode_quantized_lut(q: torch.Tensor, j: torch.Tensor,
                         params: MortonParams,
                         quirk_shift: bool = False) -> U64:
    """LUT-path key construction.

    quirk_shift=False reads byte `level` of each coordinate (shift 8*level,
    the layout the 9-group LUT implies); quirk_shift=True uses the shipped
    reference kernel's 3*level shift, whose byte windows overlap.
    """
    lo = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    hi = torch.zeros_like(lo)
    step = 3 if quirk_shift else 8
    for level in range(3):
        for axis in range(3):
            byte = (q[:, axis] >> (step * level)) & 0xFF
            grp = axis + 3 * level
            lo = lo | params.lut_lo[grp][byte]
            hi = hi | params.lut_hi[grp][byte]
    jj = j & _SIZE_INDEX_MAX
    lo = lo | params.size_lut_lo[jj]
    hi = hi | params.size_lut_hi[jj]
    return U64(lo, hi)


def encode(verts: torch.Tensor, tris: torch.Tensor, params: MortonParams,
           use_lut: bool = False, quirk_lut: bool = False) -> U64:
    """Full morton encoding: gather + quantize + key construction."""
    q, j = quantize(verts, tris, params)
    if use_lut or quirk_lut:
        return encode_quantized_lut(q, j, params, quirk_shift=quirk_lut)
    return encode_quantized(q, j)
