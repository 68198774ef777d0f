"""64-bit keys as (lo, hi) u32 planes, and radix digit extraction.

torch's uint32 and uint64 tensors reject shifts, comparisons, bincount and
scatter_add, so a u64 key crosses public functions as ``U64(lo, hi)``: two
torch.int32 tensors that hold the u32 bit patterns, the same bytes as the
JAX package's uint32 planes (``np.ndarray.view(np.int32)``). Plain torch
code widens a plane to int64 and masks it with 0xFFFFFFFF for arithmetic;
CUDA kernels take the planes as ``uint32_t*``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

U32_MASK = 0xFFFFFFFF


def as_i32(x: np.ndarray) -> np.ndarray:
    """u32 numpy array -> the int32 array with the same bytes."""
    return np.ascontiguousarray(x, dtype=np.uint32).view(np.int32)


def widen(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> its u32 value as int64."""
    return x.to(torch.int64) & U32_MASK


def narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a u32 value (or any value, taken mod 2^32) -> the
    int32 tensor with that bit pattern."""
    x = x & U32_MASK
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


class U64(NamedTuple):
    """A u64 tensor as (lo, hi) int32 planes of u32 bit patterns."""

    lo: torch.Tensor
    hi: torch.Tensor

    @property
    def shape(self):
        return self.lo.shape

    @staticmethod
    def from_numpy(x: np.ndarray, device: str | torch.device) -> "U64":
        x = np.asarray(x, dtype=np.uint64)
        lo = as_i32((x & np.uint64(U32_MASK)).astype(np.uint32))
        hi = as_i32((x >> np.uint64(32)).astype(np.uint32))
        return U64(torch.from_numpy(lo).to(device),
                   torch.from_numpy(hi).to(device))

    def to_numpy(self) -> np.ndarray:
        lo = self.lo.cpu().numpy().view(np.uint32).astype(np.uint64)
        hi = self.hi.cpu().numpy().view(np.uint32).astype(np.uint64)
        return lo | (hi << np.uint64(32))


def select_digit(lo: torch.Tensor, hi: torch.Tensor, shift: int,
                 bits: int) -> torch.Tensor:
    """The `bits` key bits starting at `shift`, as int64 in [0, 2^bits).

    Handles digits that straddle the lo/hi word boundary (e.g. shift 30
    with 6 bits).
    """
    if not (0 < bits <= 16 and 0 <= shift and shift + bits <= 64):
        raise ValueError(f"bad digit (shift={shift}, bits={bits})")
    mask = (1 << bits) - 1
    if shift + bits <= 32:
        return (widen(lo) >> shift) & mask
    if shift >= 32:
        return (widen(hi) >> (shift - 32)) & mask
    return ((widen(lo) >> shift) | (widen(hi) << (32 - shift))) & mask


def digit_schedule(key_bits: int, bits_per_pass: int) -> list[tuple[int, int]]:
    """LSD pass schedule: list of (shift, bits) covering `key_bits` bits."""
    out = []
    shift = 0
    while shift < key_bits:
        bits = min(bits_per_pass, key_bits - shift)
        out.append((shift, bits))
        shift += bits
    return out


def masked_key(lo: torch.Tensor, hi: torch.Tensor, key_bits: int) -> U64:
    """Zero all bits above `key_bits`."""
    if key_bits >= 64:
        return U64(lo, hi)
    if key_bits <= 32:
        return U64(narrow(widen(lo) & ((1 << key_bits) - 1)),
                   torch.zeros_like(hi))
    return U64(lo, narrow(widen(hi) & ((1 << (key_bits - 32)) - 1)))


def is_sorted_u64(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Non-decreasing check on u64 pairs; a 0-d bool tensor."""
    if lo.shape[0] < 2:
        return torch.tensor(True, device=lo.device)
    wl, wh = widen(lo), widen(hi)
    ok = (wh[:-1] < wh[1:]) | ((wh[:-1] == wh[1:]) & (wl[:-1] <= wl[1:]))
    return ok.all()


def pack_columns(cols: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Payload columns as int32 planes of their 32-bit patterns."""
    out = []
    for c in cols:
        if c.dtype in (torch.float32, torch.uint32):
            out.append(c.view(torch.int32))
        elif c.dtype == torch.int32:
            out.append(c)
        else:
            raise TypeError(f"unsupported payload dtype {c.dtype}")
    return out
