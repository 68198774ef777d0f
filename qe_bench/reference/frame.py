"""Plain reference of one LBVH frame: the extended morton code of every
triangle of the displaced scene, stably sorted with its triangle index.

It follows the reference project's encoder (a 64-bit code: four groups,
each of five levels of interleaved x, y, z centroid bits under one bit of
the triangle's size; 20-bit cells, a 12-bit size index of which the top 4
bits are kept) in float32 torch, op for op as the WGSL kernel rounds:
``((min + max) * 0.5 - offset) * multiplier - 0.001`` and
``sqrt(dx*dx + dy*dy + dz*dz) * size_multiplier``, each clamped and
truncated. The box's offset and multipliers are worked out here from
the box alone. With ``lower`` the arithmetic runs in bfloat16: the
control.
"""

from __future__ import annotations

import numpy as np
import torch

COORD_BITS, SIZE_INDEX_BITS, SIZE_BITS = 20, 12, 4


def box_params(box_min, box_max) -> tuple:
    """(offset, multiplier, size multiplier) of the box, in float32."""
    lo = np.array(box_min, np.float32)
    ext = np.array(box_max, np.float32) - lo
    mult = np.float32(1 << COORD_BITS) / ext
    sq = ext * ext
    diag = np.sqrt((sq[0] + sq[1]) + sq[2])
    return lo, mult, np.float32((1 << SIZE_INDEX_BITS) - 1) / diag


def codes(verts: torch.Tensor, tris: torch.Tensor, box,
          lower: bool = False) -> torch.Tensor:
    """int64 bit patterns of the triangles' 64-bit morton codes in the
    box (its lowest and highest corner)."""
    dt = torch.bfloat16 if lower else torch.float32
    dev = verts.device
    off, mult, smult = (torch.tensor(np.asarray(x), device=dev).to(dt)
                        for x in box_params(*box))
    v = verts.to(dt)[tris.long()]                     # (T, 3 corners, 3)
    mn, mx = v.amin(1), v.amax(1)
    c = (mn + mx) * torch.tensor(0.5, dtype=dt, device=dev)
    val = (c - off) * mult - torch.tensor(0.001, dtype=dt, device=dev)
    cmax = (1 << COORD_BITS) - 1
    q = torch.where(val > 0, val, 0).float().clamp(max=cmax).long()
    e = mx - mn
    e = e * e
    size = torch.sqrt((e[:, 0] + e[:, 1]) + e[:, 2]) * smult
    smax = (1 << SIZE_INDEX_BITS) - 1
    j = torch.where(size > 0, size, 0).float().clamp(max=smax).long()
    code = torch.zeros(tris.shape[0], dtype=torch.int64, device=dev)
    for level in range(COORD_BITS):
        src = COORD_BITS - 1 - level
        for axis in range(3):
            pos = 63 - ((level // 5) * 16 + (level % 5) * 3 + axis)
            code |= ((q[:, axis] >> src) & 1) << pos
    s = j >> (SIZE_INDEX_BITS - SIZE_BITS)
    for b in range(SIZE_BITS):
        code |= ((s >> b) & 1) << (16 * b)
    return code


def answer(data: dict, params: dict, lower: bool = False) -> dict:
    verts = data["verts"] + torch.tensor(params["offset"], dtype=torch.float32,
                                         device=data["verts"].device)
    code = codes(verts, data["tris"], data["box"], lower)
    # unsigned order of the codes is the signed order with the top bit
    # flipped
    flip = code ^ torch.iinfo(torch.int64).min
    order = torch.sort(flip, stable=True).indices
    code = code[order]
    return {"code_lo": (((code + (1 << 31)) & 0xFFFFFFFF)
                        - (1 << 31)).to(torch.int32),
            "code_hi": (code >> 32).to(torch.int32),
            "order": order.to(torch.int32)}
