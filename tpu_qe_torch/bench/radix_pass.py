"""Times of a radix pass's kernels (B1 histogram, B2 scan, B3 stable block
rank and rank + scatter) and of the headline sort, from the package in a
chosen source tree, so that two trees can be timed in turns in one run on
one card (parent, change, change, parent).

    python tpu_qe_torch/bench/radix_pass.py [--tree DIR] [--n 16777216]

DIR holds a `tpu_qe_torch` package (default: the tree this file lies in);
the script fails if the package it imports is not DIR's, as when another
tree's package was imported before. Only the wrappers' contract is used, so
any tree of the port can be timed. Prints one JSON row: CUDA-event
milliseconds per launch at n random keys, block BLOCK, the main path's 8-bit
digit at shift 0 unless the name says otherwise, each the smaller of two
means of 20 launches; and the headline sort's time at 4 n keys (2^26 by
default). A machine without CUDA fails.
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
    from tpu_qe_torch.bench import headline
    from tpu_qe_torch.bench.sol import card
    from tpu_qe_torch.bits import U64
    from tpu_qe_torch.constants import BLOCK
    from tpu_qe_torch.kernels import histogram as hk
    from tpu_qe_torch.kernels import scan as sk
    from tpu_qe_torch.utils.timing import cuda_time

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
    ms = {}
    for name, fn in cases.items():
        ms[name] = min(cuda_time(fn, iters=20), cuda_time(fn, iters=20)) * 1e3
    res = headline.measure(4 * n, seed=7, iters=10, device="cuda")
    row = {"tree": args.tree, "n": n, "block": BLOCK, "ms": ms,
           "device": card(),
           "headline": {k: res[k] for k in (
               "value", "time_s", "torch_sort_time_s", "vs_baseline",
               "sol_fraction", "verified")}}
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
