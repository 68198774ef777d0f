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
- ``torch_tiebreak``: the name of the JAX ``xla_tiebreak`` backend, kept
  for parity; it runs the stable ``torch`` path. The JAX backend orders by
  (key, payloads[0]) and is meant for payloads[0] = ``arange(n)`` (the
  flagship (morton code, triangle index) shape), where that order is the
  stable order; a stable sort gives it without the extra key.

A ragged tail needs no padding: the kernels mask it, which gives the same
result as the JAX driver's all-ones sentinel padding (sentinels take the
largest digit of every pass and follow every real key of the last block,
so they never move a real key).
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from tpu_qe_torch.bits import (SIGN_BIT, U64, digit_schedule, pack_columns,
                               widen)
from tpu_qe_torch.config import resolve_device
from tpu_qe_torch.constants import BLOCK
from tpu_qe_torch.kernels.histogram import block_histogram, rank_and_scatter
from tpu_qe_torch.kernels.scan import exclusive_scan
from tpu_qe_torch.utils.profiling import marker


def signed_key(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """int64 key whose signed order is the unsigned order of (hi, lo):
    ((hi ^ 0x80000000) << 32) | lo."""
    top = hi ^ SIGN_BIT     # a Python scalar: no host-to-device copy
    # top * 2^32 lies in [-2^63, 2^63): no overflow, unlike a signed shift
    return top.to(torch.int64) * (1 << 32) | (lo.to(torch.int64) & 0xFFFFFFFF)


# LSD passes of every radix sort since the last clear(), by (rows, key
# bytes per row: 4 for a lone plane, else 8, payload planes carried): the
# plan that bench-matrix's pass counts and envelopes read, beside the
# kernels' own launch counters.
RADIX_PASSES: Counter = Counter()


def _keep_bits(plane: torch.Tensor, mask: int) -> torch.Tensor:
    if mask == 0xFFFFFFFF:
        return plane
    return plane & (mask - (1 << 32) if mask >> 31 else mask)


def torch_order(lo, hi, digits, stable=True) -> torch.Tensor:
    """int64 permutation that sorts the keys by the bits the (shift, bits)
    digits cover, from one ``torch.sort``."""
    mask = 0
    for shift, bits in digits:
        mask |= ((1 << bits) - 1) << shift
    mlo = _keep_bits(lo, mask & 0xFFFFFFFF)
    # a key of one plane (hi is lo) sorts as its widened word
    key = widen(mlo) if hi is lo else signed_key(mlo, _keep_bits(hi,
                                                                 mask >> 32))
    return torch.sort(key, stable=stable).indices


def sort_radix(planes: list, digits, block=BLOCK):
    """One LSD pass of B1, B2 and B3 per (shift, bits) digit, least
    significant first, over `planes` = [lo, hi, *payloads] (hi may be lo
    for a key of one plane). Returns (lo, hi, payloads).

    The list is emptied, so a pass's input planes die when the next pass
    has run unless the caller holds them: holding a sort's gathered input
    planes through all of its passes cost ORDER BY 4 % on an H100.
    """
    lo, hi, *payloads = planes
    planes.clear()
    RADIX_PASSES[lo.shape[0], 4 if hi is lo else 8, len(payloads)] += len(
        digits)
    for i, (shift, bits) in enumerate(digits):
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
    backend is always stable, and so is ``torch_tiebreak``.
    """
    lo, hi = key
    planes = pack_columns(payloads)
    if backend in ("torch", "torch_tiebreak"):
        order = torch_order(lo, hi, [(0, key_bits)],
                            stable or backend == "torch_tiebreak")
        slo, shi, spl = lo[order], hi[order], [p[order] for p in planes]
    elif backend == "radix":
        slo, shi, spl = sort_radix([lo, hi, *planes],
                                   digit_schedule(key_bits, bits_per_pass),
                                   block)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return U64(slo, shi), tuple(spl)


def sort_u64_numpy(keys: np.ndarray, payload: np.ndarray | None = None, *,
                   device: str | torch.device = "cuda", **kw):
    """Numpy-in/numpy-out convenience wrapper (testing and benchmarking);
    sorts on `device`, the card unless the caller names another. A CUDA
    device without CUDA raises."""
    device = resolve_device(device)
    k = U64.from_numpy(keys, device)
    payloads = () if payload is None else (torch.from_numpy(
        np.ascontiguousarray(payload, dtype=np.uint32).view(np.int32)).to(
            device),)
    sk, spl = sort_u64(k, *payloads, **kw)
    sk = sk.to_numpy()
    if payload is None:
        return sk
    return sk, spl[0].cpu().numpy().view(np.uint32)
