"""Stable block rank + digit-major histogram on the tensor cores (B6).

Port of tpu_qe/kernels/rank_mxu.py::block_rank_and_histogram_mxu as a CUDA
kernel in csrc/rank_mxu.cu, with the flat-plane API of the port's B3
(tpu_qe_torch.kernels.histogram.block_rank_and_histogram), so the two are
interchangeable for 8-bit digits. Per row of 128 keys, with nibble one-hot
matrices OH_hi and OH_lo:

  SAME = (OH_hi OH_hi^T) * (OH_lo OH_lo^T),  rank_in_row = sum_{j<i} SAME
  H    = OH_hi^T OH_lo                        (the row's 16 x 16 histogram)

and a key's base is the count of its digit in the earlier rows of its
block. Those counts reach the block size, beyond what fp16, tf32 or bf16
hold exactly, so the kernel looks the base up in shared memory instead of
passing it through a tensor-core operand, and the plain twin gathers it
from an int64 prefix.
"""

from __future__ import annotations

import torch

from tpu_qe_torch.bits import select_digit
from tpu_qe_torch.constants import BLOCK
from tpu_qe_torch.kernels import (LAUNCHES, check, library, require_planes,
                                  stream_of)

ROW = 128          # keys per row, as the TPU kernel's 128 lanes
NIB = 16
_NONE = NIB        # nibble of a masked key: matches no one-hot column
_CHUNK_KEYS = 1 << 18   # plain twin: keys per batch of blocks (SAME is
                        # 512 bytes a key in float32)


def _check_args(n: int, block: int, shift: int) -> int:
    if block < 1:
        raise ValueError(f"block must be positive: {block}")
    if not 0 <= shift <= 56:
        raise ValueError(f"8-bit digit at shift {shift} is outside the key")
    if n >= 1 << 32:
        raise ValueError(f"{n} keys: u32 ranks need n < 2^32")
    nb = -(-n // block)
    if nb >= 1 << 31:
        raise ValueError(f"{nb} blocks exceed the CUDA grid")
    return nb


def nibble_hist_to_digit_major(hist_nib: torch.Tensor) -> torch.Tensor:
    """(nb, 16 high, 16 low) nibble histograms -> digit-major (256, nb);
    digit = 16 * high + low."""
    return hist_nib.reshape(hist_nib.shape[0], NIB * NIB).T


def _rank_rows_plain(nh: torch.Tensor, nl: torch.Tensor):
    """Ranks and nibble histograms of (m, R, 128) nibble rows of m blocks."""
    m, rows, _ = nh.shape
    iota = torch.arange(NIB, device=nh.device)
    oh_hi = (nh[..., None] == iota).to(torch.float32)    # (m, R, 128, 16)
    oh_lo = (nl[..., None] == iota).to(torch.float32)
    same = (oh_hi @ oh_hi.transpose(-1, -2)) * (oh_lo @ oh_lo.transpose(-1, -2))
    tri = torch.ones(ROW, ROW, device=nh.device).tril(-1)   # j < i
    rank_in_row = (same * tri).sum(-1)                   # (m, R, 128)
    h = oh_hi.transpose(-1, -2) @ oh_lo                  # (m, R, 16, 16)
    counts = h.round().to(torch.int64).reshape(m, rows, NIB * NIB)
    excl = torch.cumsum(counts, 1) - counts              # earlier rows
    digit = (nh * NIB + nl).clamp(max=NIB * NIB - 1)
    base = torch.gather(excl, 2, digit)
    ranks = rank_in_row.round().to(torch.int64) + base
    return ranks, counts.sum(1).reshape(m, NIB, NIB)


def block_rank_and_histogram_mxu_plain(lo: torch.Tensor, hi: torch.Tensor,
                                       shift: int, block: int = BLOCK):
    """Plain twin of B6: the same one-hot matrix algebra in float32 torch.
    Returns (ranks (n,) int32, hist (256, nb) int32)."""
    n = lo.shape[0]
    nb = _check_args(n, block, shift)
    rows = -(-block // ROW)
    dev = lo.device
    d = select_digit(lo, hi, shift, 8)
    ranks = torch.empty(n, dtype=torch.int32, device=dev)
    hist_nib = torch.empty((nb, NIB, NIB), dtype=torch.int64, device=dev)
    per_batch = max(1, _CHUNK_KEYS // (rows * ROW))
    pos = torch.arange(rows * ROW, device=dev)
    for b0 in range(0, nb, per_batch):
        b1 = min(nb, b0 + per_batch)
        # key index of every (block, row, lane) slot; masked past the
        # block's end and past n
        g = torch.arange(b0, b1, device=dev)[:, None] * block + pos
        valid = (pos < block) & (g < n)
        dv = d[g.clamp(max=n - 1)]
        nh = torch.where(valid, dv >> 4, _NONE).reshape(b1 - b0, rows, ROW)
        nl = torch.where(valid, dv & 15, _NONE).reshape(b1 - b0, rows, ROW)
        r, hn = _rank_rows_plain(nh, nl)
        r = r.reshape(b1 - b0, rows * ROW)
        ranks[g[valid]] = r[valid].to(torch.int32)
        hist_nib[b0:b1] = hn
    hist = nibble_hist_to_digit_major(hist_nib).contiguous()
    return ranks, hist.to(torch.int32)


def block_rank_and_histogram_mxu(lo: torch.Tensor, hi: torch.Tensor,
                                 shift: int, block: int = BLOCK):
    """Stable in-block ranks and histogram of the 8-bit digit at `shift`
    (B6): (ranks (n,) int32, hist (256, nb) int32), equal to
    block_rank_and_histogram(lo, hi, shift, 8, block)."""
    dev = require_planes(lo, hi)
    if dev.type == "cpu":
        return block_rank_and_histogram_mxu_plain(lo, hi, shift, block)
    n = lo.shape[0]
    nb = _check_args(n, block, shift)
    ranks = torch.empty(n, dtype=torch.int32, device=dev)
    hist = torch.empty((NIB * NIB, nb), dtype=torch.int32, device=dev)
    lib = library()
    check(lib, lib.tq_block_rank_and_histogram_mxu(
        lo.data_ptr(), hi.data_ptr(), n, block, shift, ranks.data_ptr(),
        hist.data_ptr(), dev.index, stream_of(lo)),
        "block_rank_and_histogram_mxu")
    LAUNCHES["block_rank_and_histogram_mxu"] += 1
    return ranks, hist
