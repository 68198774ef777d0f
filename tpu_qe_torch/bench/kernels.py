"""Per-kernel benchmarks against the card's HBM speed of light.

    python -m tpu_qe_torch bench-kernels [--n 16777216]

One JSON row per kernel, with the row names of tpu_qe/bench/kernels.py:
B4 and its plain twin beside the plain direct interleave, B1, B3's rank
mode and B3's scatter of both key words and one payload, the kernel a sort
spends its time in (all three at the main path's block, printed in the
row), and B5 on chunks of 8192. Times are CUDA-event means (tpu_qe_torch.utils.profiling); bytes
are what each kernel must read and write. A machine without CUDA fails:
nothing is timed on the CPU.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from tpu_qe_torch import morton, native
from tpu_qe_torch.bench.sol import card
from tpu_qe_torch.config import resolve_device
from tpu_qe_torch.constants import BLOCK
from tpu_qe_torch.kernels import morton as mk
from tpu_qe_torch.kernels.bitonic import sort_chunks
from tpu_qe_torch.kernels.histogram import (block_histogram,
                                            block_rank_and_histogram,
                                            rank_and_scatter)
from tpu_qe_torch.kernels.scan import exclusive_scan
from tpu_qe_torch.utils.profiling import KernelStats, profile_kernel

CHUNK = 8192


def _i32(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(dev)


def _emit(stats: KernelStats, device: dict, **extra) -> dict:
    row = {"metric": f"kernel {stats.name}",
           "value": stats.elements_per_s / 1e6, "unit": "M elem/s",
           "time_s": stats.seconds, "achieved_gbps": stats.achieved_gbps,
           "sol_fraction": stats.sol_fraction, **extra, "device": device}
    print(json.dumps(row), flush=True)
    return row


def bench_morton(n: int, dev: torch.device, device: dict) -> list[dict]:
    _, _, smin, smax = native.scene_generate(100, 300, 7)
    params = morton.MortonParams.for_scene(smin, smax, dev)
    rng = np.random.default_rng(0)
    q = _i32(rng.integers(0, 1 << 20, (n, 3), dtype=np.uint32), dev)
    j = _i32(rng.integers(0, 1 << 12, n, dtype=np.uint32), dev)
    bytes_moved = n * (4 * 4 + 8)    # read q (3 words) + j, write lo + hi
    fns = {
        "morton_lut_kernel": lambda: mk.encode_quantized_lut(
            q, j, params.lut_lo, params.lut_hi),
        "morton_lut_plain": lambda: mk.encode_quantized_lut_plain(
            q, j, params.lut_lo, params.lut_hi),
        "morton_direct_plain": lambda: morton.encode_quantized(q, j),
    }
    return [_emit(profile_kernel(name, fn, bytes_moved, n), device)
            for name, fn in fns.items()]


def bench_sort_kernels(n: int, dev: torch.device, device: dict) -> list[dict]:
    if n < CHUNK:
        raise ValueError(f"n must be at least one chunk of {CHUNK}")
    rng = np.random.default_rng(1)
    lo = _i32(rng.integers(0, 1 << 32, n, dtype=np.uint64), dev)
    hi = _i32(rng.integers(0, 1 << 32, n, dtype=np.uint64), dev)
    out = []
    # the digit at shift 8 lies in lo: the radix kernels need not read hi
    s = profile_kernel("block_histogram_r256",
                       lambda: block_histogram(lo, hi, 8, 8), n * 4, n)
    out.append(_emit(s, device, block=BLOCK))
    s = profile_kernel("block_rank_r256",
                       lambda: block_rank_and_histogram(lo, hi, 8, 8),
                       n * 8, n)
    out.append(_emit(s, device, block=BLOCK))
    # both key words and one payload in and out, plus the (radix, nb) bases
    pay = torch.arange(n, dtype=torch.int32, device=dev)
    base = exclusive_scan(block_histogram(lo, hi, 8, 8).reshape(-1))
    s = profile_kernel("rank_and_scatter_r256",
                       lambda: rank_and_scatter(lo, hi, [pay], base, 8, 8),
                       n * 24 + base.numel() * 4, n)
    out.append(_emit(s, device, block=BLOCK))
    del pay, base
    nb = n // CHUNK
    m = nb * CHUNK
    lo8, hi8 = lo[:m].reshape(nb, CHUNK), hi[:m].reshape(nb, CHUNK)
    pay = torch.arange(m, dtype=torch.int32, device=dev).reshape(nb, CHUNK)
    s = profile_kernel("bitonic_chunk8192",
                       lambda: sort_chunks(lo8, hi8, pay, rows=CHUNK // 128),
                       m * 24, m)
    out.append(_emit(s, device, chunk=CHUNK))
    return out


def run(n: int = 1 << 24) -> list[dict]:
    dev = resolve_device("cuda")
    device = card()
    return bench_morton(n, dev, device) + bench_sort_kernels(n, dev, device)

