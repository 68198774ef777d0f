"""Headline benchmark: u64 key + u32 payload radix sort on one GPU.

    python -m tpu_qe_torch.bench.headline [--n 67108864]

Prints ONE JSON line: `value` in keys/s for the radix backend,
`vs_baseline` against a stable torch.sort of the same keys and payload on
the same card, both CUDA-event times, the speed-of-light fraction against
the card's HBM peak, and the card's name and power limit. Both backends'
outputs must agree bit for bit, or the run fails. The kernels are built and
launched before the timed window. A machine without CUDA fails.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from tpu_qe_torch.bits import U64
from tpu_qe_torch.bench.sol import card, sort_sol_seconds
from tpu_qe_torch.config import resolve_device
from tpu_qe_torch.sort import sort_u64
from tpu_qe_torch.utils.timing import cuda_time


def measure(n: int, seed: int = 7, iters: int = 10,
            device: str = "cuda") -> dict:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the headline benchmark measures a CUDA device")
    keys = np.random.default_rng(seed).integers(0, 1 << 64, size=n,
                                                dtype=np.uint64)
    key = U64.from_numpy(keys, dev)
    payload = torch.arange(n, dtype=torch.int32, device=dev)

    def radix():
        return sort_u64(key, payload, backend="radix")

    def baseline():
        return sort_u64(key, payload, backend="torch")

    (rk, (rp,)), (tk, (tp,)) = radix(), baseline()
    verified = bool(torch.equal(rk.lo, tk.lo) and torch.equal(rk.hi, tk.hi)
                    and torch.equal(rp, tp))
    radix_s = cuda_time(radix, iters=iters)
    torch_s = cuda_time(baseline, iters=iters)
    sol_s = sort_sol_seconds(n, num_passes=8, payload_cols=1)
    return {
        "metric": f"radix sort {n} u64 keys + u32 payload, 1 GPU",
        "value": n / radix_s,
        "unit": "keys/s",
        "vs_baseline": torch_s / radix_s,
        "backend": "radix",
        "time_s": radix_s,
        "torch_sort_time_s": torch_s,
        "sol_fraction": sol_s / radix_s,
        "verified": verified,
        "device": card(),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpu_qe_torch bench")
    p.add_argument("--n", type=int, default=1 << 26,
                   help="number of u64 keys (default 2^26)")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    result = measure(args.n, args.seed, args.iters, args.device)
    print(json.dumps(result))
    return 0 if result["verified"] else 1


if __name__ == "__main__":
    sys.exit(main())
