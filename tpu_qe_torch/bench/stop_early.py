"""Where the time of wide B1 and B5 goes: times of copies of their CUDA
sources that leave a part out or change one constant, in one run on one
card.

    python tpu_qe_torch/bench/stop_early.py [--n 16777216] [--out DIR]

Each variant is a copy of this tree's `tpu_qe_torch` package under DIR
(default `_proof/stop_early` beside the package, a directory that
.gitignore lists) with one or a few lines of `csrc/bitonic.cu` or
`csrc/radix.cu` replaced; a child process builds it and prints one JSON row.
A copy that leaves a part out computes wrong results: only its time is
read, and `exact` says whether the variant still agrees with the plain
twin. B5 rows: ms per launch at n keys in chunks of 8192 with 0, 1 and 3
payloads. Wide B1 rows: ms per launch at n keys, block BLOCK, shift 0, at
11, 12, 13, 14 and 16 bits. The script fails if a line it replaces is no
longer in the source. A machine without CUDA fails.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# bitonic.cu: the lines of tile_kernel's merge loop
_LOOP = "  for (int m = m_lo; m <= m_hi; ++m) {"
_FIRST = "  if (m_lo == 1) {"
_LANE = "      lane_stage<INDEX>(x, 1 << (s - kRegBits), up);"
_THERE = "      relayout<INDEX>(x, shared, home, transposed);"
_BACK = "      relayout<INDEX>(x, shared, transposed, home);"
B5_VARIANTS = {
    "full": [],
    # loads, stores and the payload gather alone
    "no_network": [(_LOOP, _LOOP.replace("m <= m_hi;", "m < 0;")),
                   (_FIRST, "  if (m_lo < 0) {")],
    "register_stages_only": [(_LANE, ""), (_THERE, ""), (_BACK, "")],
    "no_transpositions": [(_THERE, ""), (_BACK, "")],
    "no_lane_stages": [(_LANE, "")],
}

# radix.cu: histogram_group_kernel's constants and its two phases
_GROUP = "constexpr int kGroup = 8; "
_WINDOW = "constexpr int kWindowBits = 12; "
_NEAR = "constexpr int kNearBits = 2; "
_THREADS = "constexpr int kGroupThreads = 256;"
_COUNT = "      for (int64_t g = start + tid; g < end; g += kGroupThreads) {"
_STORE = "    for (uint32_t i = tid; i < kPairs * span; i += kGroupThreads) {"
B1_VARIANTS = {
    "full": [],
    "count_only": [(_STORE, _STORE.replace("i < kPairs * span", "i < 0"))],
    "store_only": [(_COUNT, _COUNT.replace("g < end;", "g < end && n < 0;"))],
    "near_0": [(_NEAR, "constexpr int kNearBits = 0; ")],
    "near_3": [(_NEAR, "constexpr int kNearBits = 3; ")],
    "threads_512": [(_THREADS, "constexpr int kGroupThreads = 512;")],
    "group_16_window_11": [(_GROUP, "constexpr int kGroup = 16; "),
                           (_WINDOW, "constexpr int kWindowBits = 11; ")],
    "group_4_window_13": [(_GROUP, "constexpr int kGroup = 4; "),
                          (_WINDOW, "constexpr int kWindowBits = 13; ")],
}
SOURCES = {"b5": ("bitonic.cu", B5_VARIANTS), "b1": ("radix.cu", B1_VARIANTS)}


def make_variant(out: str, kernel: str, name: str) -> str:
    """Copy the package to out/kernel_name with the variant's edits."""
    source, variants = SOURCES[kernel]
    tree = os.path.join(out, f"{kernel}_{name}")
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(PACKAGE, os.path.join(tree, "tpu_qe_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(tree, "tpu_qe_torch", "csrc", source)
    with open(path) as f:
        text = f.read()
    for old, new in variants[name]:
        if old not in text:
            raise RuntimeError(f"{source} no longer holds the line {old!r} "
                               f"that variant {name} replaces")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return tree


def time_variant(tree: str, kernel: str, n: int) -> dict:
    """Import the package of `tree`, build it, and time the kernel."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import tpu_qe_torch
    found = os.path.realpath(tpu_qe_torch.__file__)
    if os.path.commonpath([os.path.realpath(tree), found]) != \
            os.path.realpath(tree):
        raise RuntimeError(f"imported {found}, not the package of {tree}")
    from tpu_qe_torch.bench.sol import card
    from tpu_qe_torch.bits import U64
    from tpu_qe_torch.kernels import bitonic as bk
    from tpu_qe_torch.kernels import histogram as hk
    from tpu_qe_torch.utils.timing import cuda_time

    if not torch.cuda.is_available():
        raise RuntimeError("bench/stop_early.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    key = U64.from_numpy(np.random.default_rng(3).integers(
        0, 1 << 64, size=n, dtype=np.uint64), dev)

    def best(fn):
        return min(cuda_time(fn, iters=10) for _ in range(2)) * 1e3

    row = {"ms": {}, "exact": True, "device": card()}
    if kernel == "b5":
        chunks = max(n // 8192, 1)
        lo, hi = (w[:chunks * 8192].reshape(chunks, 8192)
                  for w in (key.lo, key.hi))
        pays = [torch.arange(chunks * 8192, dtype=torch.int32,
                             device=dev).reshape(chunks, 8192) + i
                for i in range(3)]
        for got, want in zip(bk.sort_chunks(lo, hi, *pays, rows=64),
                             bk.sort_chunks_plain(lo, hi, *pays, rows=64)):
            row["exact"] &= bool(torch.equal(got, want))
        for count in (0, 1, 3):
            row["ms"][f"payloads_{count}"] = best(
                lambda: bk.sort_chunks(lo, hi, *pays[:count], rows=64))
    else:
        for bits in (11, 12, 13, 14, 16):
            row["exact"] &= bool(torch.equal(
                hk.block_histogram(key.lo, key.hi, 0, bits),
                hk.block_histogram_plain(key.lo, key.hi, 0, bits)))
            row["ms"][f"{bits}bit"] = best(
                lambda: hk.block_histogram(key.lo, key.hi, 0, bits))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 24)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(PACKAGE), "_proof", "stop_early"))
    ap.add_argument("--time", nargs=2, metavar=("TREE", "KERNEL"),
                    help="time one built variant (the children's mode)")
    args = ap.parse_args(argv)
    if args.time:
        print(json.dumps(time_variant(args.time[0], args.time[1], args.n)),
              flush=True)
        return 0
    for kernel, (_, variants) in SOURCES.items():
        for name in variants:
            tree = make_variant(args.out, kernel, name)
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--n",
                 str(args.n), "--time", tree, kernel],
                capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"variant {kernel} {name} failed:\n"
                                   f"{r.stdout}{r.stderr}")
            row = json.loads(r.stdout.strip().splitlines()[-1])
            print(json.dumps({"kernel": kernel, "variant": name, **row}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
