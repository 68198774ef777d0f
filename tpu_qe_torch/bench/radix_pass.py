"""Times of a radix pass's kernels (B1 histogram, B2 scan, B3 stable block
rank and rank + scatter) and of the headline sort, from the package in a
chosen source tree, so that two trees can be timed in turns in one run on
one card (parent, change, change, parent).

    python tpu_qe_torch/bench/radix_pass.py [--tree DIR] [--n 16777216]
        [--skip-headline]

DIR holds a `tpu_qe_torch` package (default: the tree this file lies in);
the script fails if the package it imports is not DIR's, as when another
tree's package was imported before. Only the wrappers' contract is used, so
any tree of the port can be timed. Prints one JSON row: CUDA-event
milliseconds per launch at n random keys, block BLOCK, the main path's 8-bit
digit at shift 0 unless the name says otherwise, each the smaller of two
means of 20 launches; B3's scatter also at 11- and 16-bit digits (at 11
bits also with blocks of 32768 and 65535 keys), its rank mode and B1 at 11
and 16 bits (`block_rank_11bit`, `histogram_16bit`, ...); B6 at shifts 0
and 40 and at blocks of 1024 and 8192 keys (`rank_mxu`, `rank_mxu_shift40`,
`rank_mxu_b1024`, `rank_mxu_b8192`); B5 on chunks of
8192 keys with 0, 1 and 3 payloads (`sort_chunks_8192_p1`, ...: the first
n // 8192 chunks) beside `torch.sort` of the same chunks' keys
(`torch_sort_chunks_8192_ms`); the sort of n keys and a payload in 8-,
6- and 11-bit passes
(`sort_8bit_passes`, ...: 8, 11 and 6 of them); B2 at tables of 2^17 to
2^28 words (`exclusive_scan_2pN`: n / 128 to 16 n) with
`torch.cumsum(x, 0, dtype=torch.int32)` at the same sizes
(`library_ms`), the smallest and largest of five means of 20 scans at
n / 16 words (`exclusive_scan_spread`) and, where the tree has one, the
time of an empty launch (`empty_launch_ms`); and the headline sort's time
at 4 n keys (2^26 by default). A scan of a small table ends before the host
has enqueued the next, so its `ms` is the host's pace; `queued_ms`,
`library_queued_ms` and `empty_launch_queued_ms` time the same loops
queued behind a device sleep: device time alone. A machine without CUDA
fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--n", type=int, default=1 << 24)
    ap.add_argument("--skip-headline", action="store_true",
                    help="time the kernels only")
    args = ap.parse_args(argv)
    tree = os.path.realpath(args.tree)
    sys.path.insert(0, tree)

    import numpy as np
    import torch

    import tpu_qe_torch
    found = os.path.realpath(tpu_qe_torch.__file__)
    if os.path.commonpath([tree, found]) != tree:
        raise RuntimeError(f"--tree {args.tree}: the imported tpu_qe_torch "
                           f"is {found}, not that tree's")
    from tpu_qe_torch import kernels
    from tpu_qe_torch.bench import headline
    from tpu_qe_torch.bench.sol import card
    from tpu_qe_torch.bits import U64
    from tpu_qe_torch.constants import BLOCK
    from tpu_qe_torch.kernels import histogram as hk
    from tpu_qe_torch.kernels import scan as sk
    from tpu_qe_torch.sort import sort_u64
    # this file's tree's timing, whichever tree is timed: an older tree's
    # cuda_time has no ahead_ms
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_radix_pass_timing", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "utils", "timing.py"))
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    cuda_time = timing.cuda_time

    if not torch.cuda.is_available():
        raise RuntimeError("bench/radix_pass.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    n = args.n
    key = U64.from_numpy(np.random.default_rng(7).integers(
        0, 1 << 64, size=n, dtype=np.uint64), dev)
    lo, hi = key.lo, key.hi
    pays = [torch.arange(n, dtype=torch.int32, device=dev) + i
            for i in range(3)]

    def base_of(a, b, shift, bits):
        return sk.exclusive_scan(hk.block_histogram(a, b, shift,
                                                    bits).reshape(-1))

    base8, lone8, lone1 = (base_of(lo, hi, 0, 8), base_of(lo, lo, 0, 8),
                           base_of(lo, lo, 0, 1))
    flat = hk.block_histogram(lo, hi, 0, 8).reshape(-1)
    cases = {
        "block_histogram": lambda: hk.block_histogram(lo, hi, 0, 8),
        "exclusive_scan": lambda: sk.exclusive_scan(flat),
        "block_rank": lambda: hk.block_rank_and_histogram(lo, hi, 0, 8),
        "scatter_p0": lambda: hk.rank_and_scatter(lo, hi, [], base8, 0, 8),
        "scatter_p1": lambda: hk.rank_and_scatter(lo, hi, pays[:1], base8,
                                                  0, 8),
        "scatter_p3": lambda: hk.rank_and_scatter(lo, hi, pays, base8, 0, 8),
        "scatter_p1_lone": lambda: hk.rank_and_scatter(lo, lo, pays[:1],
                                                       lone8, 0, 8),
        "scatter_p1_lone_1bit": lambda: hk.rank_and_scatter(
            lo, lo, pays[:1], lone1, 0, 1),
    }
    for bits, block in ((11, BLOCK), (16, BLOCK), (11, 32768), (11, 65535)):
        wide = sk.exclusive_scan(hk.block_histogram(
            lo, hi, 0, bits, block).reshape(-1))
        name = f"scatter_p1_{bits}bit" + (f"_b{block}" if block != BLOCK
                                          else "")
        cases[name] = (lambda wide=wide, bits=bits, block=block:
                       hk.rank_and_scatter(lo, hi, pays[:1], wide, 0, bits,
                                           block))
    for bits in (11, 16):
        cases[f"block_rank_{bits}bit"] = (
            lambda bits=bits: hk.block_rank_and_histogram(lo, hi, 0, bits))
        cases[f"histogram_{bits}bit"] = (
            lambda bits=bits: hk.block_histogram(lo, hi, 0, bits))
    # B6 (the tensor-core rank; B3's rank-mode output) at block BLOCK and
    # shifts 0 and 40, and at blocks 1024 and 8192
    from tpu_qe_torch.kernels import rank_mxu as rk
    for shift, block in ((0, BLOCK), (40, BLOCK), (0, 1024), (0, 8192)):
        name = "rank_mxu" + (f"_shift{shift}" if shift else "") + (
            f"_b{block}" if block != BLOCK else "")
        cases[name] = (lambda shift=shift, block=block:
                       rk.block_rank_and_histogram_mxu(lo, hi, shift, block))
    # B5: the first n // 8192 chunks of 8192 keys (at least one), with 0, 1
    # and 3 payloads, beside torch.sort of the same chunks' keys
    from tpu_qe_torch.kernels import bitonic as bk
    chunks = max(n // 8192, 1)
    g = torch.Generator(device=dev).manual_seed(11)
    c_lo, c_hi = (torch.randint(-(1 << 31), 1 << 31, (chunks, 8192),
                                generator=g, device=dev, dtype=torch.int32)
                  for _ in range(2))
    c_pay = [torch.arange(chunks * 8192, dtype=torch.int32,
                          device=dev).reshape(chunks, 8192) + i
             for i in range(3)]
    for count in (0, 1, 3):
        cases[f"sort_chunks_8192_p{count}"] = (
            lambda count=count: bk.sort_chunks(c_lo, c_hi, *c_pay[:count],
                                               rows=64))
    c_key = ((c_hi.to(torch.int64) ^ -(1 << 31)) * (1 << 32)
             | (c_lo.to(torch.int64) & 0xFFFFFFFF))   # signed order = u64's
    # the whole sort of n keys and one payload by `verify`'s schedules
    for bits in (8, 6, 11):
        cases[f"sort_{bits}bit_passes"] = lambda bits=bits: sort_u64(
            key, pays[0], bits_per_pass=bits)
    # B2 at the sizes of its callers' tables, from n / 128 (a 1-bit pass of
    # 16 n rows) to 16 n words (a 16-bit pass of n keys)
    g = torch.Generator(device=dev).manual_seed(7)
    library = {}
    for words in (n >> 7, n >> 4, n >> 2, n, n << 4):
        x = torch.randint(0, 1 << 16, (words,), generator=g, device=dev,
                          dtype=torch.int32)
        name = f"exclusive_scan_2p{words.bit_length() - 1}"
        cases[name] = lambda x=x: sk.exclusive_scan(x)
        library[name] = lambda x=x: torch.cumsum(x, 0, dtype=torch.int32)

    def best(fn, ahead_ms=0.0):
        return min(cuda_time(fn, iters=20, ahead_ms=ahead_ms)
                   for _ in range(2)) * 1e3

    def queued(fn):   # device time alone: the host enqueues behind a sleep
        return best(fn, ahead_ms=3.0)

    mid = f"exclusive_scan_2p{(n >> 4).bit_length() - 1}"
    spread = [cuda_time(cases[mid], iters=20) * 1e3 for _ in range(5)]
    row = {"tree": args.tree, "n": n, "block": BLOCK,
           "ms": {name: best(fn) for name, fn in cases.items()},
           "queued_ms": {name: queued(cases[name]) for name in library},
           "library_ms": {name: best(fn) for name, fn in library.items()},
           "library_queued_ms": {name: queued(fn)
                                 for name, fn in library.items()},
           "exclusive_scan_spread": [min(spread), max(spread)],
           "device": card()}
    row["torch_sort_chunks_8192_ms"] = best(
        lambda: torch.sort(c_key, dim=1))
    if hasattr(kernels, "empty_launch"):
        row["empty_launch_ms"] = best(lambda: kernels.empty_launch(dev))
        row["empty_launch_queued_ms"] = queued(
            lambda: kernels.empty_launch(dev))
    if not args.skip_headline:
        res = headline.measure(4 * n, seed=7, iters=10, device="cuda")
        row["headline"] = {k: res[k] for k in (
            "value", "time_s", "torch_sort_time_s", "vs_baseline",
            "sol_fraction", "verified")}
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
