"""Flat exclusive prefix sum of u32 (B2).

Port of tpu_qe/kernels/scan.py::exclusive_scan as a reduce-then-scan CUDA
kernel in csrc/scan.cu. Used for the flat digit-major histogram scan: one
exclusive scan of the (radix * nb) table gives every (digit, block) base.
Any length is taken (the JAX kernel needed multiples of 1024).
"""

from __future__ import annotations

import torch

from tpu_qe_torch.bits import narrow, widen
from tpu_qe_torch.kernels import (LAUNCHES, check, library, require_planes,
                                  stream_of)


def exclusive_scan_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain twin: exclusive prefix sum of u32 values mod 2^32."""
    w = widen(x)
    return narrow(torch.cumsum(w, 0) - w)


def exclusive_scan(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of a flat int32 tensor of u32 bit patterns;
    sums wrap mod 2^32 like the reference's u32 scan."""
    dev = require_planes(x)
    if dev.type == "cpu":
        return exclusive_scan_plain(x)
    n = x.shape[0]
    lib = library()
    out = torch.empty_like(x)
    scratch = torch.empty(max(lib.tq_exclusive_scan_scratch(n), 1),
                          dtype=torch.int32, device=dev)
    check(lib, lib.tq_exclusive_scan(x.data_ptr(), out.data_ptr(),
                                     scratch.data_ptr(), n, dev.index,
                                     stream_of(x)), "exclusive_scan")
    LAUNCHES["exclusive_scan"] += 1
    return out
