#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tpu_qe_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card. Phases:

1. device: the card's name and power limit (nvidia-smi) and CUDA version;
2. build: the CUDA kernels from tpu_qe_torch/csrc and the C++ core;
3. kernels: B1 (block histogram), B2 (exclusive scan) and B3 (stable rank,
   and rank + scatter) on the card, bit-exact against their plain PyTorch
   twins on the same card and against the C++ oracles, at 2^22 and
   2^22 + 777 keys over several digit positions and a skewed input; then
   each kernel's time beside its twin's at the main path's shapes;
4. main path: `verify` at 2^24 triangles for the 8x8-bit and the 6x11-bit
   schedules, bit-exact against the C++ pipeline oracle, with the kernel
   launch counts of the run;
5. headline: 2^26 random u64 keys + u32 payload sorted by the radix kernels,
   bit-exact against a stable torch.sort, with both CUDA-event times.

Then it prints the kernel summary as one JSON line, the nvidia-smi line, and
last the result line. Any failure exits nonzero; without CUDA, or outside
the repository, it exits nonzero before printing a result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"needs numpy and torch: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA card")
    try:
        import tpu_qe_torch  # noqa: F401
    except ImportError as e:
        fail(f"run from the root of the repository ({e})")

    from tpu_qe_torch import kernels, native
    from tpu_qe_torch.__main__ import main as cli
    from tpu_qe_torch.bench import headline
    from tpu_qe_torch.bits import U64, widen
    from tpu_qe_torch.constants import BLOCK
    from tpu_qe_torch.kernels import histogram as hk
    from tpu_qe_torch.kernels import scan as sk
    from tpu_qe_torch.utils.timing import cuda_time

    dev = torch.device("cuda", 0)
    sys.stdout.reconfigure(line_buffering=True)

    # -- 1. device
    smi = nvidia_smi_line()
    log(f"[1/5] device: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} card(s)")

    # -- 2. build
    t0 = time.perf_counter()
    kernels.library()
    t1 = time.perf_counter()
    native.pipeline_oracle(10, 10, 7)
    t2 = time.perf_counter()
    log(f"[2/5] build: CUDA kernels {t1 - t0:.1f} s, C++ core {t2 - t1:.1f} s")

    # -- 3. kernels against their twins and the C++ oracles
    err = {"block_histogram": 0, "exclusive_scan": 0,
           "block_rank_and_histogram": 0, "rank_and_scatter": 0}

    def compare(name: str, got: torch.Tensor, *wants) -> None:
        g = widen(got.reshape(-1))
        for w in wants:
            if isinstance(w, np.ndarray):   # u32/u64 oracle output
                w = torch.from_numpy(w.reshape(-1).astype(np.int64)).to(dev)
            else:
                w = widen(w.reshape(-1))
            if w.shape != g.shape:
                fail(f"{name}: shape {tuple(g.shape)} != {tuple(w.shape)}")
            d = int((g - w).abs().max()) if g.numel() else 0
            err[name] = max(err[name], d)
            if d:
                fail(f"{name}: differs from its reference by up to {d}")

    rng = np.random.default_rng(7)
    u64 = np.uint64
    digits = [(0, 8), (24, 8), (32, 8), (56, 8), (30, 6), (60, 4)]
    for n in (1 << 22, (1 << 22) + 777):
        rand = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
        skew = (rand & ~u64(0xFF)) | u64(0x5A)   # every key has digit 0x5A
        for label, keys, cases in (("random", rand, digits),
                                   ("skewed", skew, [(0, 8)])):
            key = U64.from_numpy(keys, dev)
            nb = -(-n // BLOCK)
            for shift, bits in cases:
                radix, p = 1 << bits, shift // bits
                hist = hk.block_histogram(key.lo, key.hi, shift, bits)
                compare("block_histogram", hist,
                        hk.block_histogram_plain(key.lo, key.hi, shift, bits),
                        native.digit_major_histogram(keys, p, bits, BLOCK))

                ranks, hist2 = hk.block_rank_and_histogram(key.lo, key.hi,
                                                           shift, bits)
                d = ((keys >> u64(shift)) & u64(radix - 1)).astype(np.int64)
                blk = np.arange(n, dtype=np.int64) // BLOCK
                want = native.block_rank((blk * radix + d).astype(np.uint32),
                                         nb * radix)
                pr, ph = hk.block_rank_and_histogram_plain(key.lo, key.hi,
                                                           shift, bits)
                compare("block_rank_and_histogram", ranks, pr, want)
                compare("block_rank_and_histogram", hist2, ph, hist)

                flat = hist.reshape(-1)
                base = sk.exclusive_scan(flat)
                h64 = flat.cpu().numpy().view(np.uint32).astype(np.uint64)
                compare("exclusive_scan", base, sk.exclusive_scan_plain(flat),
                        (np.cumsum(h64) - h64) & u64(0xFFFFFFFF))

                pay = torch.arange(n, dtype=torch.int32, device=dev)
                olo, ohi, (opay,) = hk.rank_and_scatter(key.lo, key.hi, [pay],
                                                        base, shift, bits)
                plo, phi, (ppay,) = hk.rank_and_scatter_plain(
                    key.lo, key.hi, [pay], base, shift, bits)
                compare("rank_and_scatter", olo, plo)
                compare("rank_and_scatter", ohi, phi)
                compare("rank_and_scatter", opay, ppay)
                dest = torch.empty(n, dtype=torch.int64, device=dev)
                dest[opay.to(torch.int64)] = torch.arange(n, device=dev)
                compare("rank_and_scatter", dest,
                        native.scatter_locations(keys, p, bits, BLOCK).astype(
                            np.int64))
                log(f"      n={n} {label} shift={shift} bits={bits}: "
                    "B1, B2, B3 (rank, scatter) bit-exact")
    # u32 wrap-around in the scan
    for n in (1 << 22, (1 << 22) + 777):
        x = rng.integers(1 << 31, 1 << 32, size=n, dtype=np.uint64)
        xt = torch.from_numpy(x.astype(np.uint32).view(np.int32)).to(dev)
        compare("exclusive_scan", sk.exclusive_scan(xt),
                sk.exclusive_scan_plain(xt),
                (np.cumsum(x) - x) & u64(0xFFFFFFFF))
        log(f"      n={n} exclusive_scan with u32 wrap-around: bit-exact")
    torch.cuda.synchronize()
    log(f"[3/5] kernels bit-exact against twins and C++ oracles; "
        f"max_abs_err {json.dumps(err)}")

    # Times at the main path's shapes: 2^24 keys, 8-bit digit, one payload.
    n = 1 << 24
    key = U64.from_numpy(rng.integers(0, 1 << 64, size=n, dtype=np.uint64),
                         dev)
    pay = torch.arange(n, dtype=torch.int32, device=dev)
    hist = hk.block_histogram(key.lo, key.hi, 0, 8)
    flat = hist.reshape(-1)
    base = sk.exclusive_scan(flat)
    timed = {
        "block_histogram": (
            lambda: hk.block_histogram(key.lo, key.hi, 0, 8),
            lambda: hk.block_histogram_plain(key.lo, key.hi, 0, 8)),
        "exclusive_scan": (lambda: sk.exclusive_scan(flat),
                           lambda: sk.exclusive_scan_plain(flat)),
        "rank_and_scatter": (
            lambda: hk.rank_and_scatter(key.lo, key.hi, [pay], base, 0, 8),
            lambda: hk.rank_and_scatter_plain(key.lo, key.hi, [pay], base,
                                              0, 8)),
    }
    ms = {}
    for name, (kern, plain) in timed.items():
        k1 = cuda_time(kern, iters=20)
        p1 = cuda_time(plain, iters=5)
        k2 = cuda_time(kern, iters=20)
        ms[name] = (min(k1, k2) * 1e3, p1 * 1e3)
        log(f"      {name}: kernel {ms[name][0]:.4f} ms, plain twin "
            f"{ms[name][1]:.4f} ms (2^24 keys, 8-bit digit, block {BLOCK})")
    del key, pay, hist, flat, base

    # -- 4. main path
    launches = None
    for extra, passes in (([], 8), (["--bits-per-pass", "6",
                                     "--num-passes", "11"], 11)):
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc = cli(["verify", "--triangles", "16777216", "--vertices",
                  "4194304", "--seed", "7", "--device", "cuda"] + extra)
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        log(f"      verify {' '.join(extra) or '(8 x 8 bits)'}: rc {rc}, "
            f"{time.perf_counter() - t0:.1f} s, launches {counts}")
        if rc != 0:
            fail("verify did not pass")
        for name in ("block_histogram", "exclusive_scan", "rank_and_scatter"):
            if counts[name] != passes:
                fail(f"{name} launched {counts[name]} times, not once per "
                     f"pass ({passes})")
        if launches is None:
            launches = counts
    log("[4/5] main path: VERIFY PASS at 2^24 triangles for 8x8 and 6x11")

    # -- 5. headline sort
    res = headline.measure(1 << 26, seed=7, iters=10, device="cuda")
    log(f"      {json.dumps(res)}")
    if not res["verified"]:
        fail("radix sort of 2^26 keys differs from stable torch.sort")
    log(f"[5/5] headline: radix {res['time_s'] * 1e3:.3f} ms, torch.sort "
        f"{res['torch_sort_time_s'] * 1e3:.3f} ms for 2^26 keys + payload; "
        "bit-exact")

    src = "tpu_qe_torch/csrc/"
    summary = [
        ("block_histogram", src + "radix.cu",
         "tpu_qe/kernels/histogram.py:85"),
        ("exclusive_scan", src + "scan.cu", "tpu_qe/kernels/scan.py:69"),
        ("rank_and_scatter", src + "radix.cu",
         "tpu_qe/kernels/histogram.py:164"),
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": rep,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": ms[name][0], "plain_ms": ms[name][1]}
        for name, source, rep in summary]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
