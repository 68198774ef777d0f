"""Regenerable hash key generators: the port of tpu_qe/hashing.py.

Any (key, payload) pair can be re-validated anywhere as
key == keygen_hash(payload), which the out-of-core drivers lean on, so
these stay bit-identical to the JAX functions and to their numpy mirrors.
Planes are int32 tensors of u32 bit patterns; the arithmetic runs on int64
values in [0, 2^32), where `>>` is a logical shift and products wrap
exactly through bits.mul_lo32.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_qe_torch.bits import U64, mul_lo32, narrow, widen


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 values in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = mul_lo32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul_lo32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def murmur_fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer, a bijective avalanche mix on u32; int32
    plane in, int32 plane out."""
    return narrow(_fmix32(widen(h)))


def keygen_hash(idx: torch.Tensor, seed: int = 7) -> U64:
    """Regenerable pseudorandom u64 key for global row index idx (an int32
    plane of u32 values): two independent finalizer streams form (lo, hi)."""
    x = widen(idx)
    c1 = (seed * 0x9E3779B9) & 0xFFFFFFFF
    c2 = (seed * 0x85EBCA77) & 0xFFFFFFFF
    lo = _fmix32(x ^ c1)
    hi = _fmix32(x ^ c2 ^ 0x5BD1E995)
    return U64(narrow(lo), narrow(hi))


def murmur_fmix32_numpy(h: np.ndarray) -> np.ndarray:
    """Numpy mirror of murmur_fmix32 (u32 in, u32 out)."""
    h = h.astype(np.uint32)
    h = h ^ (h >> np.uint32(16))
    h = (h * np.uint32(0x85EBCA6B)).astype(np.uint32)
    h = h ^ (h >> np.uint32(13))
    h = (h * np.uint32(0xC2B2AE35)).astype(np.uint32)
    return h ^ (h >> np.uint32(16))


def keygen_hash_numpy(idx: np.ndarray, seed: int = 7) -> np.ndarray:
    """Numpy mirror of keygen_hash: u64 keys."""
    idx = idx.astype(np.uint32)
    c1 = np.uint32((seed * 0x9E3779B9) & 0xFFFFFFFF)
    c2 = np.uint32((seed * 0x85EBCA77) & 0xFFFFFFFF)
    lo = murmur_fmix32_numpy(idx ^ c1)
    hi = murmur_fmix32_numpy(idx ^ c2 ^ np.uint32(0x5BD1E995))
    return lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
