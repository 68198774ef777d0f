"""Where the time of wide B1, B5 and B6 goes: times of copies of their CUDA
sources that leave a part out or change one constant, in one run on one
card.

    python tpu_qe_torch/bench/stop_early.py [--n 16777216] [--out DIR]
        [--kernels b5,b1,b6] [--tree TREE]

Each variant is a copy of the `tpu_qe_torch` package of this tree (or of
TREE's; `--kernels b6_fp16` takes the earlier fp16 B6, which only an
older tree holds) under DIR
(default `_proof/stop_early` beside the package, a directory that
.gitignore lists) with one or a few lines of `csrc/bitonic.cu` or
`csrc/radix.cu` or `csrc/rank_mxu.cu` replaced; a child process builds it
and prints one JSON row.
A copy that leaves a part out computes wrong results: only its time is
read, and `exact` says whether the variant still agrees with the plain
twin. B5 rows: ms per launch at n keys in chunks of 8192 with 0, 1 and 3
payloads. Wide B1 rows: ms per launch at n keys, block BLOCK, shift 0, at
11, 12, 13, 14 and 16 bits. B6 rows: ms per launch at n keys, block BLOCK,
at shifts 0 and 40. The script fails if a line it replaces is no longer in
the source. A machine without CUDA fails.
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
# the earlier fp16 rank_mxu.cu (m16n8k16 products, 8 rows of 128 keys at a
# time): time it from a tree that holds it (--tree)
_SAME = "    for (int i0 = 0; i0 < kRow; i0 += 16) {"
_HIST = "    for (int k0 = 0; k0 < kRow; k0 += 16) {"
_WSCAN = "      for (int w = 0; w < kWarps; ++w) {"
B6_FP16_VARIANTS = {
    "full": [],
    "no_same": [(_SAME, _SAME.replace("i0 < kRow", "i0 < 0"))],
    "no_hist_products": [(_HIST, _HIST.replace("k0 < kRow", "k0 < 0"))],
    "no_warp_scan": [(_WSCAN, _WSCAN.replace("w < kWarps", "w < 0"))],
    "loads_stores_only": [(_SAME, _SAME.replace("i0 < kRow", "i0 < 0")),
                          (_HIST, _HIST.replace("k0 < kRow", "k0 < 0")),
                          (_WSCAN, _WSCAN.replace("w < kWarps", "w < 0"))],
}
# rank_mxu.cu: the SAME products (their counting folds away with them),
# the histogram products, the table stores of a step, the warp scan
_SAME6 = [(f"      mma({d}, a{d[1]}, wh[{k}], wl[{k}]);", "")
          for d, k in (("d00", 0), ("d01", 1), ("d10", 0), ("d11", 1),
                       ("d12", 2), ("d13", 3))]
_HPROD = [("      mma(h0, ha, eq16(x0l, vg), eq16(x1l, vg));", ""),
          ("      mma(h1, ha, eq16(x0l, vg8), eq16(x1l, vg8));", "")]
_TABLE = [("      store_counts(tw, h0, h1, g, t);", "")]
_SCAN = [(_WSCAN, _WSCAN.replace("w < kWarps", "w < 0"))]
_BOUNDS = "__launch_bounds__(kThreads)"
_SEG = "constexpr int kSegment = 4096;"
_STEPS = "    for (int s0 = run0; s0 < run1; s0 += 32) {"
_QUAD = ["      uint32_t quad = d << (8 * t);",
         "      quad |= __shfl_xor_sync(0xFFFFFFFFu, quad, 1);",
         "      quad |= __shfl_xor_sync(0xFFFFFFFFu, quad, 2);"]
B6_VARIANTS = {
    "full": [],
    "no_same": _SAME6,
    "no_hist_products": _HPROD,
    "no_step_table": _TABLE,
    "no_warp_scan": _SCAN,
    "loads_stores_only": _SAME6 + _HPROD + _TABLE + _SCAN,
    # tuning: blocks per SM the registers must allow; smaller segments; two
    # steps a loop turn; the group's four digits read from shared memory
    "blocks_5": [(_BOUNDS, "__launch_bounds__(kThreads, 5)")],
    "blocks_6": [(_BOUNDS, "__launch_bounds__(kThreads, 6)")],
    "segment_2048": [(_SEG, _SEG.replace("4096", "2048"))],
    "unroll_2": [(_STEPS, "#pragma unroll 2\n" + _STEPS)],
    "quad_from_shared": [
        (_QUAD[0], "      const uint32_t quad = digits[s0 + g] | digits[s0 + "
                   "g + 8] << 8 | digits[s0 + g + 16] << 16 | digits[s0 + g "
                   "+ 24] << 24;"),
        (_QUAD[1], ""), (_QUAD[2], "")],
}
SOURCES = {"b5": ("bitonic.cu", B5_VARIANTS), "b1": ("radix.cu", B1_VARIANTS),
           "b6": ("rank_mxu.cu", B6_VARIANTS)}
# and the kernels of older trees, for --tree
ALL_SOURCES = {**SOURCES, "b6_fp16": ("rank_mxu.cu", B6_FP16_VARIANTS)}


def make_variant(out: str, kernel: str, name: str,
                 package: str = PACKAGE) -> str:
    """Copy `package` to out/kernel_name with the variant's edits."""
    source, variants = ALL_SOURCES[kernel]
    tree = os.path.join(out, f"{kernel}_{name}")
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(package, os.path.join(tree, "tpu_qe_torch"),
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
    from tpu_qe_torch.kernels import rank_mxu as rk
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
    elif kernel.startswith("b6"):
        for shift in (0, 40):
            for got, want in zip(
                    rk.block_rank_and_histogram_mxu(key.lo, key.hi, shift),
                    hk.block_rank_and_histogram(key.lo, key.hi, shift, 8)):
                row["exact"] &= bool(torch.equal(got, want))
            row["ms"][f"shift_{shift}"] = best(
                lambda: rk.block_rank_and_histogram_mxu(key.lo, key.hi,
                                                        shift))
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
    ap.add_argument("--kernels", default=",".join(SOURCES),
                    help="comma-separated subset of " + ",".join(ALL_SOURCES))
    ap.add_argument("--tree", default=os.path.dirname(PACKAGE),
                    help="the tree whose tpu_qe_torch is copied")
    ap.add_argument("--time", nargs=2, metavar=("TREE", "KERNEL"),
                    help="time one built variant (the children's mode)")
    args = ap.parse_args(argv)
    if args.time:
        print(json.dumps(time_variant(args.time[0], args.time[1], args.n)),
              flush=True)
        return 0
    for kernel in args.kernels.split(","):
        for name in ALL_SOURCES[kernel][1]:
            tree = make_variant(args.out, kernel, name,
                                os.path.join(args.tree, "tpu_qe_torch"))
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
