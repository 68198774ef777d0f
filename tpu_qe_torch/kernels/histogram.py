"""Per-block digit histogram (B1) and stable block rank + scatter (B3).

Ports of tpu_qe/kernels/histogram.py::block_histogram and
::block_rank_and_histogram, as CUDA kernels in csrc/radix.cu, plus
``rank_and_scatter``: B3 fused with the scatter that the JAX driver
emulates with jnp.take + lax.sort.

Keys are flat (n,) int32 (lo, hi) planes cut into blocks of `block` keys;
a ragged last block is masked, not padded. Histograms are digit-major,
(radix, nb) with nb = ceil(n / block), so one flat exclusive scan gives
every (digit, block) base. Each entry point launches its kernel for CUDA
tensors and uses its plain PyTorch twin (``*_plain``) for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from tpu_qe_torch.bits import select_digit, widen
from tpu_qe_torch.constants import BLOCK
from tpu_qe_torch.kernels import (LAUNCHES, check, library, require_planes,
                                  stream_of)

MAX_KERNEL_BITS = 8     # shared-memory counters hold up to 256 digits
MAX_PAYLOADS = 8        # payload planes per rank_and_scatter launch


def _num_blocks(n: int, block: int) -> int:
    if block < 1:
        raise ValueError(f"block must be positive: {block}")
    return -(-n // block)


def _check_kernel_args(n: int, block: int, shift: int, bits: int) -> int:
    if not (1 <= bits <= MAX_KERNEL_BITS):
        raise ValueError(f"the CUDA radix kernels take 1..{MAX_KERNEL_BITS}"
                         f"-bit digits, got {bits}")
    if shift < 0 or shift + bits > 64:
        raise ValueError(f"digit (shift={shift}, bits={bits}) outside the key")
    if n >= 1 << 32:
        raise ValueError(f"{n} keys: u32 destinations need n < 2^32")
    nb = _num_blocks(n, block)
    if nb >= 1 << 31:
        raise ValueError(f"{nb} blocks exceed the CUDA grid")
    return nb


# ---------------------------------------------------------------- plain twins

def block_histogram_plain(lo: torch.Tensor, hi: torch.Tensor, shift: int,
                          bits: int, block: int = BLOCK) -> torch.Tensor:
    """Plain twin of B1: (radix, nb) int32 digit counts per block."""
    n = lo.shape[0]
    nb, radix = _num_blocks(n, block), 1 << bits
    d = select_digit(lo, hi, shift, bits)
    b = torch.arange(n, device=lo.device) // block
    counts = torch.bincount(d * nb + b, minlength=radix * nb)
    return counts.to(torch.int32).reshape(radix, nb)


def block_rank_and_histogram_plain(lo: torch.Tensor, hi: torch.Tensor,
                                   shift: int, bits: int,
                                   block: int = BLOCK):
    """Plain twin of B3's rank mode: (ranks (n,) int32, hist (radix, nb))."""
    n = lo.shape[0]
    nb, radix = _num_blocks(n, block), 1 << bits
    d = select_digit(lo, hi, shift, bits)
    b = torch.arange(n, device=lo.device) // block
    key = b * radix + d
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=nb * radix)
    starts = torch.cumsum(counts, 0) - counts
    ranks = torch.empty(n, dtype=torch.int64, device=lo.device)
    ranks[order] = torch.arange(n, device=lo.device) - starts[key[order]]
    hist = counts.reshape(nb, radix).T.contiguous().to(torch.int32)
    return ranks.to(torch.int32), hist


def scatter_destinations_plain(lo: torch.Tensor, hi: torch.Tensor,
                               base: torch.Tensor, shift: int, bits: int,
                               block: int = BLOCK) -> torch.Tensor:
    """int64 destination of every key: base[digit * nb + block] + rank."""
    n = lo.shape[0]
    nb = _num_blocks(n, block)
    ranks, _ = block_rank_and_histogram_plain(lo, hi, shift, bits, block)
    d = select_digit(lo, hi, shift, bits)
    b = torch.arange(n, device=lo.device) // block
    return widen(base)[d * nb + b] + ranks.to(torch.int64)


def rank_and_scatter_plain(lo: torch.Tensor, hi: torch.Tensor,
                           payloads: Sequence[torch.Tensor],
                           base: torch.Tensor, shift: int, bits: int,
                           block: int = BLOCK):
    """Plain twin of B3's scatter mode."""
    dest = scatter_destinations_plain(lo, hi, base, shift, bits, block)
    outs = []
    for plane in (lo, hi, *payloads):
        out = torch.empty_like(plane)
        out[dest] = plane
        outs.append(out)
    return outs[0], outs[1], outs[2:]


# ------------------------------------------------------------------- kernels

def block_histogram(lo: torch.Tensor, hi: torch.Tensor, shift: int,
                    bits: int, block: int = BLOCK) -> torch.Tensor:
    """Digit-major per-block histogram (B1): (radix, nb) int32 holding u32
    counts, matching tpu_qe_torch.native.digit_major_histogram."""
    dev = require_planes(lo, hi)
    if dev.type == "cpu":
        return block_histogram_plain(lo, hi, shift, bits, block)
    n = lo.shape[0]
    nb = _check_kernel_args(n, block, shift, bits)
    hist = torch.empty((1 << bits, nb), dtype=torch.int32, device=dev)
    lib = library()
    check(lib, lib.tq_block_histogram(
        lo.data_ptr(), hi.data_ptr(), n, block, shift, bits, hist.data_ptr(),
        dev.index, stream_of(lo)), "block_histogram")
    LAUNCHES["block_histogram"] += 1
    return hist


def block_rank_and_histogram(lo: torch.Tensor, hi: torch.Tensor, shift: int,
                             bits: int, block: int = BLOCK):
    """Stable in-block ranks (B3, rank mode) plus B1's histogram.

    Returns ranks (n,) int32 — each key's occurrence index among equal
    digits of its block, in input order — and hist (radix, nb) int32.
    """
    dev = require_planes(lo, hi)
    if dev.type == "cpu":
        return block_rank_and_histogram_plain(lo, hi, shift, bits, block)
    n = lo.shape[0]
    nb = _check_kernel_args(n, block, shift, bits)
    ranks = torch.empty(n, dtype=torch.int32, device=dev)
    hist = torch.empty((1 << bits, nb), dtype=torch.int32, device=dev)
    lib = library()
    check(lib, lib.tq_block_rank_and_histogram(
        lo.data_ptr(), hi.data_ptr(), n, block, shift, bits, ranks.data_ptr(),
        hist.data_ptr(), dev.index, stream_of(lo)), "block_rank_and_histogram")
    LAUNCHES["block_rank_and_histogram"] += 1
    return ranks, hist


def rank_and_scatter(lo: torch.Tensor, hi: torch.Tensor,
                     payloads: Sequence[torch.Tensor], base: torch.Tensor,
                     shift: int, bits: int, block: int = BLOCK):
    """One LSD pass's scatter (B3 fused with the scatter).

    `base` is the flat (radix * nb,) exclusive scan of B1's histogram. Key
    words and every payload plane go to base[digit * nb + block] + stable
    rank, into new tensors. Returns (lo, hi, [payloads]).
    """
    dev = require_planes(lo, hi, *payloads)
    n = lo.shape[0]
    nb = _num_blocks(n, block)
    require_planes(base)
    if base.device != dev or base.shape[0] != (1 << bits) * nb:
        raise ValueError(f"base must hold radix * nb = {(1 << bits) * nb} "
                         f"words on {dev}")
    if dev.type == "cpu":
        return rank_and_scatter_plain(lo, hi, payloads, base, shift, bits,
                                      block)
    _check_kernel_args(n, block, shift, bits)
    if len(payloads) > MAX_PAYLOADS:
        raise ValueError(f"at most {MAX_PAYLOADS} payload planes per pass")
    out_lo, out_hi = torch.empty_like(lo), torch.empty_like(hi)
    outs = [torch.empty_like(p) for p in payloads]
    ptrs_in = (ctypes.c_void_p * MAX_PAYLOADS)(
        *[p.data_ptr() for p in payloads])
    ptrs_out = (ctypes.c_void_p * MAX_PAYLOADS)(*[o.data_ptr() for o in outs])
    lib = library()
    check(lib, lib.tq_rank_and_scatter(
        lo.data_ptr(), hi.data_ptr(), n, block, shift, bits, base.data_ptr(),
        out_lo.data_ptr(), out_hi.data_ptr(), ptrs_in, ptrs_out,
        len(payloads), dev.index, stream_of(lo)), "rank_and_scatter")
    LAUNCHES["rank_and_scatter"] += 1
    return out_lo, out_hi, outs
