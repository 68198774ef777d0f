"""Multi-pass LSD radix sort driver (one device).

Backends:

- ``radix`` (default): per pass, B1 builds the digit-major block histogram,
  B2 scans it flat into every (digit, block) base, and B3 ranks each key
  stably in its block and scatters key words and payloads to
  base + rank, into ping-pong buffers. The counterpart of the JAX
  ``hybrid`` backend, with a real scatter in place of the destination sort.
- ``torch``: ``torch.sort`` on an int64 key whose top bit is flipped, so
  signed order equals unsigned order (morton codes set bit 63). The
  counterpart of the JAX ``xla`` baseline.

A ragged tail needs no padding: the kernels mask it, which gives the same
result as the JAX driver's all-ones sentinel padding (sentinels take the
largest digit of every pass and follow every real key of the last block,
so they never move a real key).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_qe_torch.bits import U64, digit_schedule, masked_key, pack_columns
from tpu_qe_torch.constants import BLOCK
from tpu_qe_torch.kernels.histogram import block_histogram, rank_and_scatter
from tpu_qe_torch.kernels.scan import exclusive_scan
from tpu_qe_torch.utils.profiling import marker


def signed_key(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """int64 key whose signed order is the unsigned order of (hi, lo):
    ((hi ^ 0x80000000) << 32) | lo."""
    top = hi ^ torch.tensor(-(1 << 31), dtype=torch.int32, device=hi.device)
    # top * 2^32 lies in [-2^63, 2^63): no overflow, unlike a signed shift
    return top.to(torch.int64) * (1 << 32) | (lo.to(torch.int64) & 0xFFFFFFFF)


def _sort_torch(lo, hi, payloads, key_bits, stable):
    mlo, mhi = masked_key(lo, hi, key_bits)
    order = torch.sort(signed_key(mlo, mhi), stable=stable).indices
    return lo[order], hi[order], [p[order] for p in payloads]


def _sort_radix(lo, hi, payloads, key_bits, bits_per_pass, block):
    for i, (shift, bits) in enumerate(digit_schedule(key_bits, bits_per_pass)):
        with marker(f"radix sort histogram pass {i}"):
            hist = block_histogram(lo, hi, shift, bits, block)
        with marker(f"radix sort scan pass {i}"):
            base = exclusive_scan(hist.reshape(-1))
        with marker(f"radix sort scatter pass {i}"):
            lo, hi, payloads = rank_and_scatter(lo, hi, payloads, base, shift,
                                                bits, block)
    return lo, hi, payloads


def sort_u64(key: U64, *payloads: torch.Tensor, key_bits: int = 64,
             backend: str = "radix", bits_per_pass: int = 8,
             block: int = BLOCK, stable: bool = True):
    """Stable sort of u64 keys (as (lo, hi) int32 planes) with 32-bit
    payload planes, on the keys' device.

    Sorts by the low `key_bits` bits of the key; the keys keep their high
    bits. Returns (U64, payloads tuple); inputs are not modified.
    `stable=False` lets the torch backend use an unstable sort; the radix
    backend is always stable.
    """
    lo, hi = key
    planes = pack_columns(payloads)
    if backend == "torch":
        slo, shi, spl = _sort_torch(lo, hi, planes, key_bits, stable)
    elif backend == "radix":
        slo, shi, spl = _sort_radix(lo, hi, planes, key_bits, bits_per_pass,
                                    block)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return U64(slo, shi), tuple(spl)


def sort_u64_numpy(keys: np.ndarray, payload: np.ndarray | None = None, *,
                   device: str | torch.device = "cpu", **kw):
    """Numpy-in/numpy-out convenience wrapper (testing and benchmarking)."""
    k = U64.from_numpy(keys, device)
    payloads = () if payload is None else (torch.from_numpy(
        np.ascontiguousarray(payload, dtype=np.uint32).view(np.int32)).to(
            device),)
    sk, spl = sort_u64(k, *payloads, **kw)
    sk = sk.to_numpy()
    if payload is None:
        return sk
    return sk, spl[0].cpu().numpy().view(np.uint32)
