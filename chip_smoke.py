#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tpu_qe_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card. Phases:

1. device: the card's name and power limit (nvidia-smi) and CUDA version;
2. build: the CUDA kernels from tpu_qe_torch/csrc and the C++ core;
3. radix kernels: B1 (block histogram), B2 (exclusive scan) and B3 (stable
   rank, and rank + scatter) on the card, bit-exact against their plain
   PyTorch twins on the same card and against the C++ oracles, at 2^22 and
   2^22 + 777 keys over several digit positions of 1..8 bits and of 11 and
   16 bits, random and skewed inputs, and a lone key plane passed as both
   words (as sort_planes passes it) at 1- and 8-bit digits; then B3's
   hard shapes (blocks of 1000, 4096, 5000 and 65536 keys against its
   4096-key tile; 0, 3 and 8 payload planes; a digit that straddles bit
   32; every key on one digit; n of 1, tile - 1 and tile + 1); then each
   kernel's time beside its twin's at the main path's shapes (8-bit
   digits, and B1/B3 at 11 and 16 bits), on outputs that are compared
   again, B3's scatter also with 0 and 3 payloads and on a lone plane,
   and the one PyTorch call that computes B2's function (torch.cumsum);
   then B1, B2 and B3's scatter against their twins at the
   operators' sizes, 2^28 and 2 x 10^8 keys, at an 8-bit digit and at a
   1-bit digit of a lone plane. B2 also at its own hard shapes (n of 0, 1,
   one tile - 1, a tile, a tile + 1, no multiple of 4, 2^17, 2^24 and 2^28
   words; all-ones words, which wrap in every tile's aggregate; one large
   word then zeros; a slice that starts 4 bytes into a tensor), 1000 scans
   back to back on one stream with fresh scratch each, and a scan while
   another stream keeps the card busy; B3's scatter and rank mode at 9, 11,
   13 and 16 bits (every key on one digit, each key its own digit, a digit
   that straddles bit 32; 0 and 3 payloads; blocks of 4096, 5000, 32768
   and 65535 keys; n of 1, tile - 1 and tile + 1). B2's times at tables of
   2^17 to 2^28 words stand beside torch.cumsum's and a bound that is the
   larger of its bytes at the HBM peak and an empty kernel's launch, the
   wide scatter's beside its byte bound and the bound of the 32-byte
   sectors its stores touch; wide B1 (9..16-bit digits) at the shapes its
   grouped kernel finds hard: 9, 11, 13 and 16 bits, blocks of 1000, 4096,
   5000, 32768 and 65535 keys, n of 1, 4095, 4097, 2^22 + 777 and 2^24
   (2^28 at 11 bits), a digit that straddles bit 32, a block of 65535 keys
   on one digit, keys on two digits only, 20 calls back to back into
   recycled memory and a call beside a busy stream, against its twin and
   numpy; its and the wide rank mode's times at 11 and 16 bits beside
   their byte bounds;
4. B4 (morton LUT encode; quirk on and off, ragged n),
   B5 (bitonic chunk sort; rows 1, 2, 4, 8 and 64 and a chunk wider than
   its tile, heavy ties, 0, 1, 3 and 8 payloads; all keys equal, chunks in
   and against order, one chunk and an odd number of chunks) and B6
   (tensor-core rank; random and skewed digits, blocks 1024, 2048, 4096,
   8192 and 65535, shifts 0, 28 and 40), bit-exact against their twins and
   oracles; then each kernel's time beside its twin's, on outputs that are
   compared again, and torch.sort's beside B5's; B6's beside its bound,
   the tensor-core price of its products and the parent kernel's time;
5. main path: `verify` at 2^24 triangles for the 8x8-bit, 6x11-bit and
   11x6-bit schedules, bit-exact against the C++ pipeline oracle, with the
   kernel launch counts of each run;
6. LUT encode path: `morton.encode(use_lut=True)` and `(quirk_lut=True)`
   on the verify scene (2^24 triangles), bit-exact against the C++ encoder,
   with B4's launches counted;
7. self-check: `python -m tpu_qe_torch.selfcheck`'s main() must return 0;
   B5's and B6's launches are counted there;
8. bench-kernels at 2^24: one JSON row per kernel;
9. headline: 2^26 random u64 keys + u32 payload sorted by the radix kernels,
   bit-exact against a stable torch.sort, with both CUDA-event times;
10. operators: `bench-matrix` through the CLI at full size for filter_agg
   (2^28 rows), join and join_agg (100M x 100M), and smaller for orderby,
   count_distinct, setop and pipeline: each config bit-exact between the
   radix and torch backends and holding its invariants, B1, B2 and B3
   launched once per pass that the sort driver recorded; then
   filter + GROUP BY and the join at 2^24 rows bit-exact against numpy.

Then it prints the kernel summary as one JSON line (per kernel: launches on
the main path, largest difference from its references, its time, its plain
twin's, the least time the card could take for the same bytes or
operations, and the time of the one PyTorch call that computes the same
function, where there is one), the nvidia-smi line, and last the result
line. Any failure exits nonzero; without CUDA, or outside
the repository, it exits nonzero before printing a result.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


START = time.perf_counter()


def log(msg: str) -> None:
    if msg.startswith("["):     # a phase's closing line: seconds so far
        msg += f" [{time.perf_counter() - START:.0f} s]"
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

    from tpu_qe_torch import kernels, morton, native, selfcheck
    from tpu_qe_torch.__main__ import main as cli
    from tpu_qe_torch.bench import headline
    from tpu_qe_torch.bench.sol import hbm_peak_bytes_per_s
    from tpu_qe_torch.bits import U64, widen
    from tpu_qe_torch.constants import BLOCK
    from tpu_qe_torch.kernels import bitonic as bk
    from tpu_qe_torch.kernels import histogram as hk
    from tpu_qe_torch.kernels import morton as mk
    from tpu_qe_torch.kernels import rank_mxu as rk
    from tpu_qe_torch.kernels import scan as sk
    from tpu_qe_torch.utils.timing import cuda_time

    dev = torch.device("cuda", 0)
    sys.stdout.reconfigure(line_buffering=True)

    # -- 1. device
    smi = nvidia_smi_line()
    log(f"[1/10] device: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} card(s)")

    # -- 2. build
    t0 = time.perf_counter()
    kernels.library()
    t1 = time.perf_counter()
    native.pipeline_oracle(10, 10, 7)
    t2 = time.perf_counter()
    log(f"[2/10] build: CUDA kernels {t1 - t0:.1f} s, C++ core {t2 - t1:.1f} s")

    # -- 3. kernels against their twins and the C++ oracles
    err = {name: 0 for name in kernels.LAUNCHES}

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

    def tensors(out) -> list:     # a kernel's outputs, flattened in order
        if isinstance(out, torch.Tensor):
            return [out]
        return [t for o in out for t in tensors(o)]

    def compare_outputs(name: str, kern, plain) -> None:
        got, want = tensors(kern()), tensors(plain())
        if len(got) != len(want):
            fail(f"{name}: {len(got)} outputs, its twin {len(want)}")
        for g, w in zip(got, want):
            compare(name, g, w)

    rng = np.random.default_rng(7)
    u64 = np.uint64
    digits = [(0, 8), (24, 8), (32, 8), (56, 8), (30, 6), (60, 4)]
    wide = [(0, 11), (22, 11), (53, 11), (0, 16), (16, 16), (48, 16)]

    def skewed(keys, shift, bits):    # every key has the same digit
        mask = u64(((1 << bits) - 1) << shift)
        return (keys & ~mask) | ((u64(0x5A5A) << u64(shift)) & mask)

    for n in (1 << 22, (1 << 22) + 777):
        rand = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
        runs = [("random", rand, digits + wide),
                ("skewed", skewed(rand, 0, 8), [(0, 8)])]
        runs += [("skewed", skewed(rand, sh, b), [(sh, b)])
                 for sh, b in ((22, 11), (48, 16))]
        # hi is lo: sort_planes' key of one plane (its u64 is lo | lo << 32)
        runs.append(("lone plane", (rand & u64(0xFFFFFFFF))
                     * u64(0x100000001), [(0, 1), (24, 8)]))
        for label, keys, cases in runs:
            key = U64.from_numpy(keys, dev)
            lo, hi = key.lo, key.lo if label == "lone plane" else key.hi
            nb = -(-n // BLOCK)
            for shift, bits in cases:
                radix, p = 1 << bits, shift // bits
                aligned = shift % bits == 0   # the C++ oracles take p * bits
                hist = hk.block_histogram(lo, hi, shift, bits)
                compare("block_histogram", hist,
                        hk.block_histogram_plain(lo, hi, shift, bits),
                        *([native.digit_major_histogram(keys, p, bits, BLOCK)]
                          if aligned else []))

                ranks, hist2 = hk.block_rank_and_histogram(lo, hi, shift,
                                                           bits)
                d = ((keys >> u64(shift)) & u64(radix - 1)).astype(np.int64)
                blk = np.arange(n, dtype=np.int64) // BLOCK
                want = native.block_rank((blk * radix + d).astype(np.uint32),
                                         nb * radix)
                pr, ph = hk.block_rank_and_histogram_plain(lo, hi, shift,
                                                           bits)
                compare("block_rank_and_histogram", ranks, pr, want)
                compare("block_rank_and_histogram", hist2, ph, hist)

                flat = hist.reshape(-1)
                base = sk.exclusive_scan(flat)
                h64 = flat.cpu().numpy().view(np.uint32).astype(np.uint64)
                compare("exclusive_scan", base, sk.exclusive_scan_plain(flat),
                        (np.cumsum(h64) - h64) & u64(0xFFFFFFFF))

                pay = torch.arange(n, dtype=torch.int32, device=dev)
                olo, ohi, (opay,) = hk.rank_and_scatter(lo, hi, [pay], base,
                                                        shift, bits)
                plo, phi, (ppay,) = hk.rank_and_scatter_plain(
                    lo, hi, [pay], base, shift, bits)
                compare("rank_and_scatter", olo, plo)
                compare("rank_and_scatter", ohi, phi)
                compare("rank_and_scatter", opay, ppay)
                dest = torch.empty(n, dtype=torch.int64, device=dev)
                dest[opay.to(torch.int64)] = torch.arange(n, device=dev)
                compare("rank_and_scatter", dest, *(
                    [native.scatter_locations(keys, p, bits, BLOCK).astype(
                        np.int64)] if aligned else [
                        np.argsort(np.argsort(d, kind="stable"))]))
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
    # B3's hard shapes: blocks that are not multiples of its 4096-key tile
    # or hold many tiles, 0/3/8 payload planes, a straddling digit, a lone
    # plane, every key on one digit, and sizes around one tile.
    def check_b3(keys, lone, shift, bits, block, n_pay):
        n = len(keys)
        key = U64.from_numpy(keys, dev)
        lo, hi = key.lo, key.lo if lone else key.hi
        radix, nb = 1 << bits, -(-n // block)
        d = ((keys >> u64(shift)) & u64(radix - 1)).astype(np.int64)
        blk = np.arange(n, dtype=np.int64) // block
        ranks, hist = hk.block_rank_and_histogram(lo, hi, shift, bits, block)
        pr, ph = hk.block_rank_and_histogram_plain(lo, hi, shift, bits, block)
        compare("block_rank_and_histogram", ranks, pr, native.block_rank(
            (blk * radix + d).astype(np.uint32), nb * radix))
        compare("block_rank_and_histogram", hist, ph)
        base = sk.exclusive_scan(hist.reshape(-1))
        pays = [torch.arange(n, dtype=torch.int32, device=dev) * (2 * i + 1)
                + i for i in range(n_pay)]
        compare_outputs(
            "rank_and_scatter",
            lambda: hk.rank_and_scatter(lo, hi, pays, base, shift, bits,
                                        block),
            lambda: hk.rank_and_scatter_plain(lo, hi, pays, base, shift,
                                              bits, block))
        olo, _, _ = hk.rank_and_scatter(lo, hi, pays, base, shift, bits,
                                        block)
        order = np.argsort(d, kind="stable")   # one pass = stable digit sort
        compare("rank_and_scatter", olo,
                (keys & u64(0xFFFFFFFF))[order])

    tile = 4096
    n = (1 << 20) + 777
    rand = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    hard = [("random", rand, False, 28, 8), ("random", rand, False, 0, 8),
            ("skewed", skewed(rand, 24, 8), False, 24, 8),
            ("lone plane", (rand & u64(0xFFFFFFFF)) * u64(0x100000001), True,
             0, 1)]
    for block in (1000, 4096, 5000, 65536):
        for n_pay in (0, 3, 8):
            for label, keys, lone, shift, bits in hard:
                check_b3(keys, lone, shift, bits, block, n_pay)
        for m in (1, tile - 1, tile + 1):
            check_b3(rand[:m], False, 28, 8, block, 1)
        log(f"      n={n} block={block}: B3 rank and scatter bit-exact with "
            "0, 3 and 8 payloads (straddling, aligned, skewed and lone-plane "
            f"1-bit digits) and at n = 1, {tile - 1}, {tile + 1}")
    # The wide scatter (a sort of the tile, no table for a one-tile block,
    # a u16 table touched once per run otherwise) and the wide rank mode.
    n = (1 << 18) + 777
    rand = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    for bits in (9, 11, 13, 16):
        straddle = 32 - bits // 2
        # each key of a run of 2^bits keys on its own digit
        own = (np.arange(n, dtype=np.uint64) * u64(40503)) & u64(
            (1 << bits) - 1)
        hard = [("one digit", skewed(rand, 0, bits), 0),
                ("own digits", (rand & ~u64((1 << bits) - 1)) | own, 0),
                ("straddling", rand, straddle)]
        for block in (4096, 5000, 32768, 65535):
            for n_pay in (0, 3):
                for label, keys, shift in hard:
                    check_b3(keys, False, shift, bits, block, n_pay)
            for m in (1, tile - 1, tile + 1):
                check_b3(rand[:m], False, straddle, bits, block, 1)
        log(f"      n={n} bits={bits}: wide B3 rank and scatter bit-exact at "
            "blocks 4096, 5000, 32768 and 65535 with 0 and 3 payloads (one "
            "digit, own digits, straddling) and at n = 1, "
            f"{tile - 1}, {tile + 1}")

    # Wide B1: groups of eight key blocks counted per window of 4096
    # digits and stored as whole sectors (csrc/radix.cu).
    def check_b1(keys, shift, bits, block, oracle):
        key = U64.from_numpy(keys, dev)
        got = hk.block_histogram(key.lo, key.hi, shift, bits, block)
        wants = [hk.block_histogram_plain(key.lo, key.hi, shift, bits, block)]
        if oracle:
            n, nb = len(keys), -(-len(keys) // block)
            d = ((keys >> u64(shift)) & u64((1 << bits) - 1)).astype(np.int64)
            wants.append(np.bincount(
                d * nb + np.arange(n, dtype=np.int64) // block,
                minlength=nb << bits))
        compare("block_histogram", got, *wants)
        return got

    n = (1 << 18) + 777
    rand = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    big = rng.integers(0, 1 << 64, size=1 << 24, dtype=np.uint64)
    b1_blocks = (1000, 4096, 5000, 32768, 65535)
    for bits in (9, 11, 13, 16):
        straddle = 32 - bits // 2
        mask = u64((1 << bits) - 1)
        own = (np.arange(n, dtype=np.uint64) * u64(40503)) & mask
        # digits 1 and 2^bits - 1 only: the rest of the table is zeros
        two = (rand & ~mask) | np.where(rand >> u64(63), mask, u64(1))
        for block in b1_blocks:
            for keys, shift in ((skewed(rand, 0, bits), 0),
                                ((rand & ~mask) | own, 0), (two, 0),
                                (rand, straddle)):
                check_b1(keys, shift, bits, block, True)
            for m in (1, 4095, 4097):
                check_b1(rand[:m], straddle, bits, block, True)
        for m, blocks in (((1 << 22) + 777, (4096, 65535)),
                          (1 << 24, (4096,))):
            for block in blocks:
                check_b1(big[:m], straddle, bits, block, False)
        full = check_b1(skewed(big[:3 * 65535 + 10], 0, bits), 0, bits, 65535,
                        True)
        if full[0x5A5A & ((1 << bits) - 1)].tolist() != [65535] * 3 + [10]:
            fail(f"block_histogram: a block of 65535 keys on one {bits}-bit "
                 "digit is not counted as 65535")
        log(f"      bits={bits}: wide B1 bit-exact at blocks "
            f"{', '.join(map(str, b1_blocks))} (one digit, own digits, two "
            f"digits, straddling; n = {n}, 1, 4095, 4097), at 2^22 + 777 and "
            "2^24 keys, and with 65535 keys of a block on one digit")
    # 20 calls back to back: the allocator hands the last table out again,
    # with the last call's counts in it; two inputs in turns.
    for bits in (11, 16):
        mask = u64((1 << bits) - 1)
        two = (rand & ~mask) | np.where(rand >> u64(63), mask, u64(1))
        keys2 = [U64.from_numpy(a, dev) for a in (two, big[:70_777])]
        wants = [hk.block_histogram_plain(k.lo, k.hi, 0, bits) for k in keys2]
        bad = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(20):
            k = keys2[i % 2]
            bad += (hk.block_histogram(k.lo, k.hi, 0, bits)
                    != wants[i % 2]).sum()
        if int(bad):
            fail(f"block_histogram: {int(bad)} words differ over 20 calls "
                 f"back to back at {bits} bits")
    side = torch.cuda.Stream(dev)
    a = torch.randn(8192, 8192, device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(10):
            a @ a
    check_b1(big[:(1 << 22) + 777], 24, 16, 4096, False)
    torch.cuda.synchronize()
    del a, big, keys2, wants
    log("      wide B1: 20 calls back to back into recycled memory (11 and "
        "16 bits) and a call beside a busy stream bit-exact")

    # B2's hard shapes. Its tile is 8192 words (csrc/scan.cu).
    from tpu_qe_torch.bench.matrix import rand_u32
    scan_tile = 8192
    g = torch.Generator(device=dev).manual_seed(5)

    def scan_input(kind: str, n: int) -> torch.Tensor:
        if kind == "random":
            return rand_u32(n, g, dev)
        if kind == "all ones":      # wraps in every tile's aggregate
            return torch.full((n,), -1, dtype=torch.int32, device=dev)
        x = torch.zeros(n, dtype=torch.int32, device=dev)
        x[:1] = -16                 # 0xFFFFFFF0, then zeros
        return x

    def check_scan(x: torch.Tensor) -> None:
        compare_outputs("exclusive_scan", lambda: sk.exclusive_scan(x),
                        lambda: sk.exclusive_scan_plain(x))

    for n in (0, 1, scan_tile - 1, scan_tile, scan_tile + 1,
              3 * scan_tile + 3, 1 << 17, 1 << 20, 1 << 22, 1 << 24, 1 << 28):
        for kind in ("random", "all ones", "large then zeros"):
            x = scan_input(kind, n + 1)
            check_scan(x[:n])
            check_scan(x[1:])       # starts 4 bytes into its tensor
            del x
        log(f"      n={n} exclusive_scan (random, all ones, one large word "
            "then zeros; aligned and 4 bytes off): bit-exact")
    torch.cuda.empty_cache()
    # 1000 scans back to back, fresh scratch each (the allocator hands the
    # same memory out again, with the last scan's status words in it), two
    # lengths in turns so that stale words differ in kind.
    xs = [scan_input("random", m) for m in ((1 << 20) + 5, 300_000)]
    wants = [sk.exclusive_scan_plain(x) for x in xs]
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(1000):
        bad += (sk.exclusive_scan(xs[i % 2]) != wants[i % 2]).sum()
    if int(bad):
        fail(f"exclusive_scan: {int(bad)} words differ over 1000 scans back "
             "to back")
    # A scan while another stream keeps the card busy: no hang, same result.
    side = torch.cuda.Stream(dev)
    a = torch.randn(8192, 8192, device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(20):
            a @ a
    x = scan_input("random", 1 << 24)
    for _ in range(10):
        got = sk.exclusive_scan(x)
    compare("exclusive_scan", got, sk.exclusive_scan_plain(x))
    torch.cuda.synchronize()
    del a, x, xs, wants, got
    log("      exclusive_scan: 1000 scans back to back with fresh scratch "
        "and a scan beside a busy stream bit-exact")
    torch.cuda.synchronize()
    log("[3/10] radix kernels bit-exact against twins and C++ oracles; "
        "max_abs_err " + json.dumps({k: err[k] for k in (
            "block_histogram", "exclusive_scan", "block_rank_and_histogram",
            "rank_and_scatter")}))

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
        "block_rank_and_histogram": (
            lambda: hk.block_rank_and_histogram(key.lo, key.hi, 0, 8),
            lambda: hk.block_rank_and_histogram_plain(key.lo, key.hi, 0, 8)),
        "rank_and_scatter": (
            lambda: hk.rank_and_scatter(key.lo, key.hi, [pay], base, 0, 8),
            lambda: hk.rank_and_scatter_plain(key.lo, key.hi, [pay], base,
                                              0, 8)),
    }
    # Least time the card could take: every input read once and every
    # output written once at the HBM peak, or the operations at the card's
    # peak rate for their type, whichever is larger. Operations per key are
    # what the function needs, counted from the simplest kernel for it:
    # integer work against the 67 TFLOP/s of float32 outside the tensor
    # cores.
    hbm = hbm_peak_bytes_per_s()
    alu = 67e12

    def bound(nbytes: int, ops: float):
        t_bytes, t_ops = nbytes / hbm * 1e3, ops / alu * 1e3
        return ((t_bytes, "bytes") if t_bytes >= t_ops
                else (t_ops, "operations"))

    # No kernel ends sooner than an empty one: the floor under a bound
    # whose bytes take less. Timed queued behind a device sleep, so that
    # the host's pace stays out of it (utils/timing.py), as are B2's times.
    floor_ms = min(cuda_time(lambda: kernels.empty_launch(dev), iters=20,
                             ahead_ms=3.0) for _ in range(2)) * 1e3
    log(f"      launch floor: an empty kernel takes {floor_ms:.4f} ms "
        "(20 launches queued behind a device sleep)")

    def scan_bound(words: int):
        t, by = bound(2 * words * 4, words * 2)
        return (t, by) if t >= floor_ms else (floor_ms, "launch")

    table = 256 * (n // BLOCK) * 4          # the (radix, nb) words
    bounds = {
        # digit in lo: one key word in; shift, mask, atomic add per key
        "block_histogram": bound(n * 4 + table, n * 4),
        "exclusive_scan": scan_bound(flat.numel()),
        # one key word in, a rank out; 8 ballots and the counter per key
        "block_rank_and_histogram": bound(n * 8 + table, n * 40),
        "rank_and_scatter": bound(n * 24 + table, n * 40),
    }
    library = {
        "exclusive_scan": lambda: torch.cumsum(flat, 0, dtype=torch.int32)}
    ms, lib_ms = {}, {name: None for name in kernels.LAUNCHES}

    def time_kernel(name, kern, plain, plain_iters=5, what=""):
        # B2 ends before the host has enqueued the next scan: queue it
        ahead = 3.0 if name == "exclusive_scan" else 0.0
        compare_outputs(name, kern, plain)
        k1 = cuda_time(kern, iters=20, ahead_ms=ahead)
        p1 = cuda_time(plain, iters=plain_iters, warmup=1)
        k2 = cuda_time(kern, iters=20, ahead_ms=ahead)
        ms[name] = (min(k1, k2) * 1e3, p1 * 1e3)
        line = (f"      {name}: kernel {ms[name][0]:.4f} ms, plain twin "
                f"{ms[name][1]:.4f} ms, bound {bounds[name][0]:.4f} ms by "
                f"{bounds[name][1]}")
        if name in library:
            lib_ms[name] = cuda_time(library[name], iters=20,
                                     ahead_ms=ahead) * 1e3
            line += f", library call {lib_ms[name]:.4f} ms"
        log(f"{line} ({what})")

    for name, (kern, plain) in timed.items():
        time_kernel(name, kern, plain,
                    what=f"2^24 keys, 8-bit digit, block {BLOCK}")
    # B3's scatter at the other plane counts of the operators' sorts
    pay3 = [pay, pay + 1, pay + 2]
    base_lone = sk.exclusive_scan(hk.block_histogram(
        key.lo, key.lo, 0, 8).reshape(-1))
    for label, args, nbytes in (
            ("0 payloads", (key.lo, key.hi, [], base), n * 16 + table),
            ("3 payloads", (key.lo, key.hi, pay3, base), n * 40 + table),
            ("lone plane, 1 payload", (key.lo, key.lo, [pay], base_lone),
             n * 24 + table)):
        compare_outputs("rank_and_scatter",
                        lambda: hk.rank_and_scatter(*args, 0, 8),
                        lambda: hk.rank_and_scatter_plain(*args, 0, 8))
        t = min(cuda_time(lambda: hk.rank_and_scatter(*args, 0, 8), iters=20)
                for _ in range(2)) * 1e3
        log(f"      rank_and_scatter, {label}: kernel {t:.4f} ms, bound "
            f"{bound(nbytes, n * 40)[0]:.4f} ms by bytes")
    del pay3, base_lone
    # B2 at its callers' table sizes: a 1-bit pass at 2^28 rows, an 8-bit
    # pass at 2^24 keys (the row above), at the headline's 2^26 keys and at
    # 2^28 rows, a 16-bit pass at 2^24 keys. `host-paced` is the same loop
    # without the sleep ahead of it: what a caller sees who does nothing
    # else between two scans.
    for words in (1 << 17, 1 << 20, 1 << 22, 1 << 24, 1 << 28):
        x = scan_input("random", words) & 0xFFFF
        check_scan(x)
        t = min(cuda_time(lambda: sk.exclusive_scan(x), iters=20,
                          ahead_ms=3.0) for _ in range(2)) * 1e3
        paced = cuda_time(lambda: sk.exclusive_scan(x), iters=20) * 1e3
        lib = min(cuda_time(lambda: torch.cumsum(x, 0, dtype=torch.int32),
                            iters=20, ahead_ms=3.0) for _ in range(2)) * 1e3
        b_ms, b_by = scan_bound(words)
        log(f"      exclusive_scan, {words} words: kernel {t:.4f} ms "
            f"(host-paced {paced:.4f}), bound {b_ms:.4f} ms by {b_by}, "
            f"library call {lib:.4f} ms")
        del x
    wide_ms, wide_bounds = {}, {}
    for bits in (11, 16):
        hist = hk.block_histogram(key.lo, key.hi, 0, bits)
        base = sk.exclusive_scan(hist.reshape(-1))
        timed = {
            "block_histogram": (
                lambda: hk.block_histogram(key.lo, key.hi, 0, bits),
                lambda: hk.block_histogram_plain(key.lo, key.hi, 0, bits)),
            "block_rank_and_histogram": (
                lambda: hk.block_rank_and_histogram(key.lo, key.hi, 0, bits),
                lambda: hk.block_rank_and_histogram_plain(key.lo, key.hi, 0,
                                                          bits)),
            "rank_and_scatter": (
                lambda: hk.rank_and_scatter(key.lo, key.hi, [pay], base, 0,
                                            bits),
                lambda: hk.rank_and_scatter_plain(key.lo, key.hi, [pay],
                                                  base, 0, bits)),
        }
        for name, (kern, plain) in timed.items():
            compare_outputs(name, kern, plain)
            k1 = cuda_time(kern, iters=10)
            p1 = cuda_time(plain, iters=3, warmup=1)
            wide_ms[(name, bits)] = (k1 * 1e3, p1 * 1e3)
            line = (f"      {name}: kernel {k1 * 1e3:.4f} ms, plain twin "
                    f"{p1 * 1e3:.4f} ms")
            if name != "rank_and_scatter":
                # Bytes: the one key word the digit covers in, the dense
                # (radix, nb) table out and, in rank mode, a rank per key.
                nbytes = n * (4 if name == "block_histogram" else 8) + (
                    4 * hist.numel())
                wide_bounds[(name, bits)] = bound(nbytes, n * 4)
                line += (f", bound {wide_bounds[(name, bits)][0]:.4f} ms by "
                         f"{wide_bounds[(name, bits)][1]}")
            if name == "rank_and_scatter":
                # Bytes: three planes in and out and the base words it must
                # read, at most one per key. Sectors: with runs this short
                # each 4-byte store and base read takes a 32-byte sector.
                runs = int((hist != 0).sum())
                line += (f", bound {bound(n * 24 + runs * 4, n * 40)[0]:.4f} "
                         "ms by bytes, "
                         f"{bound(n * 12 + (3 * n + runs) * 32, 0)[0]:.4f} "
                         "ms by 32-byte sectors")
            log(f"{line} (2^24 keys, {bits}-bit digit, block {BLOCK})")
    del key, lo, hi, pay, hist, flat, base

    # The operators' sizes: filter_agg sorts 2^28 rows, its last pass a
    # 1-bit digit of a lone flag plane; the joins sort 2 x 10^8 rows.
    for n in (1 << 28, 200_000_000):
        g = torch.Generator(device=dev).manual_seed(n)
        lo, hi = rand_u32(n, g, dev), rand_u32(n, g, dev)
        pay = torch.arange(n, dtype=torch.int32, device=dev)
        for shift, bits, pair in ((0, 8, (lo, hi)), (0, 1, (lo, lo))):
            hist = hk.block_histogram(*pair, shift, bits)
            compare("block_histogram", hist,
                    hk.block_histogram_plain(*pair, shift, bits))
            flat = hist.reshape(-1)
            compare_outputs("exclusive_scan",
                            lambda: sk.exclusive_scan(flat),
                            lambda: sk.exclusive_scan_plain(flat))
            base = sk.exclusive_scan(flat)
            compare_outputs(
                "rank_and_scatter",
                lambda: hk.rank_and_scatter(*pair, [pay], base, shift, bits),
                lambda: hk.rank_and_scatter_plain(*pair, [pay], base, shift,
                                                  bits))
            log(f"      n={n} shift={shift} bits={bits}"
                f"{' lone plane' if bits == 1 else ''}: B1, B2, B3 scatter "
                "bit-exact against their twins")
            del hist, flat, base
        if n == 1 << 28:
            compare("block_histogram", hk.block_histogram(lo, hi, 0, 11),
                    hk.block_histogram_plain(lo, hi, 0, 11))
            log(f"      n={n} bits=11: wide B1 bit-exact against its twin")
        del lo, hi, pay
        torch.cuda.empty_cache()

    # -- 4. B4, B5 and B6 against their twins and oracles
    def planes(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(
            np.int32)).to(dev)

    def words(codes: np.ndarray):     # u64 oracle codes -> (lo, hi) words
        return codes & u64(0xFFFFFFFF), codes >> u64(32)

    _, _, smin, smax = native.scene_generate(100, 300, 7)
    gen = native.MortonGen(smin, smax)
    params = morton.MortonParams.from_native(gen, dev)
    params_cpu = morton.MortonParams.from_native(gen, "cpu")
    for n in (0, 1, 1023, (1 << 22) + 777):
        q = rng.integers(0, 1 << 20, (n, 3), dtype=np.uint32)
        j = rng.integers(0, 1 << 12, n, dtype=np.uint32)
        qt, jt = planes(q), planes(j)
        for quirk in (False, True):
            got = mk.encode_quantized_lut(qt, jt, params.lut_lo,
                                          params.lut_hi, quirk)
            plain = mk.encode_quantized_lut_plain(qt, jt, params.lut_lo,
                                                  params.lut_hi, quirk)
            # the size-LUT formulation on the CPU
            ref = morton.encode_quantized_lut(qt.cpu(), jt.cpu(), params_cpu,
                                              quirk)
            compare("encode_quantized_lut", got.lo, plain.lo, ref.lo.to(dev))
            compare("encode_quantized_lut", got.hi, plain.hi, ref.hi.to(dev))
            if not quirk:
                wlo, whi = words(native.morton_encode_direct(
                    np.concatenate([q, j[:, None]], axis=1)))
                compare("encode_quantized_lut", got.lo, wlo)
                compare("encode_quantized_lut", got.hi, whi)
        log(f"      n={n}: B4 (quirk off and on) bit-exact")

    def spread(p0: np.ndarray) -> np.ndarray:   # payloads derived from p0
        return (p0.astype(np.uint64) * u64(2654435761)) & u64(0xFFFFFFFF)

    for n_pay in (0, 1, 3, 8):
        wide = 4 * bk.shared_tile(1 << 30, 2 + n_pay, dev) // 128
        for rows in (1, 2, 4, 8, 64, wide):
            # an odd number of chunks for the narrow ones, which share a tile
            nb = max(1, (1 << 19) // (rows * 128)) + (rows < 8)
            for ties in (False, True):
                shape = (nb, rows * 128)
                if ties:
                    lo = rng.integers(0, 4, shape, dtype=np.uint32)
                    hi = rng.integers(0, 2, shape, dtype=np.uint32)
                else:
                    lo = rng.integers(0, 1 << 32, shape, dtype=np.uint64)
                    hi = rng.integers(0, 1 << 32, shape, dtype=np.uint64)
                p0 = np.arange(nb * rows * 128, dtype=np.uint32).reshape(shape)
                pays = ([p0] + [spread(p0 + i) for i in range(1, n_pay)]
                        if n_pay else [])
                ins = [planes(a) for a in (lo, hi, *pays)]
                outs = bk.sort_chunks(*ins, rows=rows)
                twin = bk.sort_chunks_plain(*ins, rows=rows)
                for o, w in zip(outs, twin):
                    compare("sort_chunks", o, w)
                key = (lo.astype(np.uint64)
                       | (hi.astype(np.uint64) << u64(32)))
                olo, ohi, *opay = (o.cpu().numpy().view(np.uint32)
                                   for o in outs)
                okey = olo.astype(np.uint64) | (ohi.astype(np.uint64)
                                                << u64(32))
                if not np.array_equal(okey, np.sort(key, axis=1)):
                    fail("sort_chunks: chunks not sorted like numpy")
                if n_pay:
                    # every payload travels with its key
                    op0 = opay[0]
                    order_in = np.lexsort((p0, key), axis=-1)
                    order_out = np.lexsort((op0, okey), axis=-1)
                    if not np.array_equal(
                            np.take_along_axis(p0, order_in, 1),
                            np.take_along_axis(op0, order_out, 1)):
                        fail("sort_chunks: payload 0 left its key")
                for i, o in enumerate(opay[1:], start=1):
                    if not np.array_equal(o, spread(op0 + i)):
                        fail(f"sort_chunks: payload {i} left payload 0")
                log(f"      rows={rows} (width {rows * 128}) nb={nb} "
                    f"payloads={n_pay} ties={ties}: B5 bit-exact")

    # all keys equal (every exchange is a tie), chunks in and against
    # order, one chunk and an odd number of chunks
    for rows in (1, 8, 64, 4 * bk.shared_tile(1 << 30, 3, dev) // 128):
        for nb in (1, 3):
            shape = (nb, rows * 128)
            key = np.sort(rng.integers(0, 1 << 64, shape, dtype=np.uint64),
                          axis=1)
            for label, k in (("all equal", np.full(shape, 7, dtype=np.uint64)),
                             ("sorted", key), ("reversed", key[:, ::-1])):
                p0 = np.arange(nb * rows * 128, dtype=np.uint32).reshape(shape)
                ins = [planes(a) for a in (*words(k), p0, spread(p0))]
                for o, w in zip(bk.sort_chunks(*ins, rows=rows),
                                bk.sort_chunks_plain(*ins, rows=rows)):
                    compare("sort_chunks", o, w)
        log(f"      rows={rows} nb=1, 3: B5 bit-exact on all-equal, sorted "
            "and reversed chunks")

    n = (1 << 22) + 777
    rand = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    for label, keys, shifts in (
            ("random", rand, (0, 28, 40)),
            ("digits {0,1}", rng.integers(0, 2, size=n, dtype=np.uint64),
             (0,)),
            ("one digit", (rand & ~u64(0xFF)) | u64(0x5A), (0,))):
        key = U64.from_numpy(keys, dev)
        for block in (1024, 2048, 4096, 8192, 65535):
            nb = -(-n // block)
            blk = np.arange(n, dtype=np.int64) // block
            for shift in shifts:
                r, h = rk.block_rank_and_histogram_mxu(key.lo, key.hi, shift,
                                                       block)
                tr, th = rk.block_rank_and_histogram_mxu_plain(
                    key.lo, key.hi, shift, block)
                r3, h3 = hk.block_rank_and_histogram(key.lo, key.hi, shift,
                                                     8, block)
                d = ((keys >> u64(shift)) & u64(255)).astype(np.int64)
                want = native.block_rank((blk * 256 + d).astype(np.uint32),
                                         nb * 256)
                compare("block_rank_and_histogram_mxu", r, tr, r3, want)
                compare("block_rank_and_histogram_mxu", h, th, h3)
                log(f"      n={n} {label} block={block} shift={shift}: "
                    "B6 bit-exact against twin, B3 and the C++ rank")
    torch.cuda.synchronize()
    log("[4/10] B4, B5, B6 bit-exact against twins and oracles; max_abs_err "
        + json.dumps({k: err[k] for k in ("encode_quantized_lut",
                                          "sort_chunks",
                                          "block_rank_and_histogram_mxu")}))

    # Times at the shapes of bench-kernels: 2^24 keys; B5 in chunks of 8192
    # with one payload; B6 at the main path's block.
    n = 1 << 24
    q = planes(rng.integers(0, 1 << 20, (n, 3), dtype=np.uint32))
    j = planes(rng.integers(0, 1 << 12, n, dtype=np.uint32))
    key = U64.from_numpy(rng.integers(0, 1 << 64, size=n, dtype=np.uint64),
                         dev)
    lo8, hi8 = key.lo.reshape(-1, 8192), key.hi.reshape(-1, 8192)
    pay8 = torch.arange(n, dtype=torch.int32, device=dev).reshape(-1, 8192)
    timed = {
        "encode_quantized_lut": (
            lambda: mk.encode_quantized_lut(q, j, params.lut_lo,
                                            params.lut_hi),
            lambda: mk.encode_quantized_lut_plain(q, j, params.lut_lo,
                                                  params.lut_hi)),
        "sort_chunks": (lambda: bk.sort_chunks(lo8, hi8, pay8, rows=64),
                        lambda: bk.sort_chunks_plain(lo8, hi8, pay8,
                                                     rows=64)),
        "block_rank_and_histogram_mxu": (
            lambda: rk.block_rank_and_histogram_mxu(key.lo, key.hi, 0),
            lambda: rk.block_rank_and_histogram_mxu_plain(key.lo, key.hi,
                                                          0)),
    }
    bounds.update({
        # 4 words in, 2 out; 9 LUT reads and their ORs per key
        "encode_quantized_lut": bound(n * 24, n * 30),
        # 3 planes in and out; 91 stages of n / 2 compare-exchanges of a
        # two-word key and a payload, about 8 operations each
        "sort_chunks": bound(n * 24, n * 91 * 4),
        # B3's rank-mode function (one key word in, a rank out), so B3's
        # bound: the function needs no matrix product. The kernel's own
        # products are the cost of the method, not of the function (below).
        "block_rank_and_histogram_mxu": bound(n * 8 + table, n * 40),
    })
    # torch.sort orders the chunks' keys as B5 does; its order of tied
    # payloads is its own, B5's is the JAX network's.
    top8 = hi8 ^ torch.tensor(-(1 << 31), dtype=torch.int32, device=dev)
    skey8 = (top8.to(torch.int64) * (1 << 32)
             | (lo8.to(torch.int64) & 0xFFFFFFFF))   # signed order = u64 order
    library["sort_chunks"] = lambda: torch.sort(skey8, dim=1)
    for name, (kern, plain) in timed.items():
        time_kernel(name, kern, plain, plain_iters=3, what="2^24 keys")
    # B6's 8 m16n8k32 u8 products (8192 operations each) per 32 keys at the
    # card's dense int8 rate; the fp16 kernel it replaced (160 m16n8k16
    # products per 128 keys) took 0.768 ms on an H100 80GB HBM3 at 700 W
    mxu_price = n / 32 * 8 * 8192 / 1979e12 * 1e3
    log(f"      block_rank_and_histogram_mxu: kernel "
        f"{ms['block_rank_and_histogram_mxu'][0]:.4f} ms, bound "
        f"{bounds['block_rank_and_histogram_mxu'][0]:.4f} ms by bytes, its "
        f"products {mxu_price:.4f} ms on the tensor cores, the fp16 kernel "
        "it replaced 0.768 ms")
    for count in (0, 3):
        pays = [pay8 + i for i in range(count)]
        compare_outputs("sort_chunks",
                        lambda: bk.sort_chunks(lo8, hi8, *pays, rows=64),
                        lambda: bk.sort_chunks_plain(lo8, hi8, *pays,
                                                     rows=64))
        t = min(cuda_time(lambda: bk.sort_chunks(lo8, hi8, *pays, rows=64),
                          iters=20) for _ in range(2)) * 1e3
        b_ms, b_by = bound(n * (16 + 8 * count), n * 91 * 4)
        log(f"      sort_chunks, {count} payloads: kernel {t:.4f} ms, bound "
            f"{b_ms:.4f} ms by {b_by}")
    del top8, skey8, pays
    del q, j, key, lo8, hi8, pay8

    # -- 5. main path
    launches = None
    for extra, passes in (([], 8), (["--bits-per-pass", "6",
                                     "--num-passes", "11"], 11),
                          (["--bits-per-pass", "11", "--num-passes", "6"],
                           6)):
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
    log("[5/10] main path: VERIFY PASS at 2^24 triangles for 8x8, 6x11 "
        "and 11x6")

    # -- 6. LUT encode path on the verify scene: B4 through morton.encode
    verts, tris, smin, smax = native.scene_generate(4194304, 16777216, 7)
    gen = native.MortonGen(smin, smax)
    params = morton.MortonParams.from_native(gen, dev)
    verts_t = torch.from_numpy(verts).to(dev)
    tris_t = torch.from_numpy(tris.astype(np.int32)).to(dev)
    for flag in ("use_lut", "quirk_lut"):
        kernels.reset_launches()
        code = morton.encode(verts_t, tris_t, params, **{flag: True})
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        if counts["encode_quantized_lut"] != 1:
            fail(f"encode({flag}=True) launched B4 "
                 f"{counts['encode_quantized_lut']} times, not once")
        launches["encode_quantized_lut"] += counts["encode_quantized_lut"]
        wlo, whi = words(gen.encode(verts, tris, quirk=flag == "quirk_lut"))
        compare("encode_quantized_lut", code.lo, wlo)
        compare("encode_quantized_lut", code.hi, whi)
        log(f"      encode({flag}=True) at 2^24 triangles: bit-exact against "
            f"the C++ encoder, launches {counts}")
    t_lut = cuda_time(lambda: morton.encode(verts_t, tris_t, params,
                                            use_lut=True), iters=5)
    t_direct = cuda_time(lambda: morton.encode(verts_t, tris_t, params),
                         iters=5)
    del verts, tris, verts_t, tris_t, code
    log(f"[6/10] LUT encode path: B4 bit-exact on the verify scene; encode "
        f"(quantize + B4) {t_lut * 1e3:.4f} ms, plain direct encode "
        f"{t_direct * 1e3:.4f} ms at 2^24 triangles")

    # -- 7. on-card self-check
    kernels.reset_launches()
    rc = selfcheck.main()
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    log(f"      selfcheck launches {counts}")
    if rc != 0:
        fail("selfcheck failed")
    for name in kernels.LAUNCHES:
        if counts[name] < 1:
            fail(f"selfcheck never launched {name}")
    # The three kernels on no sort path take their count from this run.
    off_path = ("block_rank_and_histogram", "sort_chunks",
                "block_rank_and_histogram_mxu")
    for name in off_path:
        launches[name] = counts[name]
    log("[7/10] selfcheck: SELFCHECK PASS")

    # -- 8. per-kernel bench
    kernels.reset_launches()
    if cli(["bench-kernels", "--n", str(1 << 24)]) != 0:
        fail("bench-kernels failed")
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    for name in ("encode_quantized_lut", "sort_chunks", "block_histogram",
                 "block_rank_and_histogram"):
        if counts[name] < 1:
            fail(f"bench-kernels never launched {name}")
    log(f"[8/10] bench-kernels at 2^24: launches {counts}")

    # -- 9. headline sort
    res = headline.measure(1 << 26, seed=7, iters=10, device="cuda")
    log(f"      {json.dumps(res)}")
    if not res["verified"]:
        fail("radix sort of 2^26 keys differs from stable torch.sort")
    log(f"[9/10] headline: radix {res['time_s'] * 1e3:.3f} ms, torch.sort "
        f"{res['torch_sort_time_s'] * 1e3:.3f} ms for 2^26 keys + payload; "
        "bit-exact")

    # -- 10. operators: bench-matrix through the CLI, then a numpy oracle
    t0 = time.perf_counter()
    op_launches = {name: 0 for name in kernels.LAUNCHES}
    for configs, scale in (("filter_agg", "1.0"), ("join", "1.0"),
                           ("join_agg", "1.0"), ("orderby", "0.25"),
                           ("count_distinct", "0.25"), ("setop", "0.25"),
                           ("pipeline", "0.25")):
        kernels.reset_launches()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli(["bench-matrix", "--configs", configs, "--scale",
                      scale])
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        rows = [json.loads(line) for line in buf.getvalue().splitlines()
                if line.startswith("{")]
        for row in rows:
            log(f"      {json.dumps(row)}")
        if rc != 0 or not rows:
            fail(f"bench-matrix {configs}: rc {rc}, {len(rows)} rows")
        planned = sum(r["sort_passes"] * r["radix_runs"] for r in rows)
        for name in ("block_histogram", "exclusive_scan", "rank_and_scatter"):
            if counts[name] != planned:
                fail(f"bench-matrix {configs}: {name} launched "
                     f"{counts[name]} times, the sorts planned {planned} "
                     "passes")
        for name in op_launches:
            op_launches[name] += counts[name]
        log(f"      {configs} (scale {scale}): radix and torch backends "
            f"bit-exact, invariants hold; launches {counts} = planned "
            f"passes {planned}")
    for name in ("block_histogram", "exclusive_scan", "rank_and_scatter"):
        launches[name] += op_launches[name]

    # numpy oracle at 2^24 rows: filter + GROUP BY, and the FK join
    from tpu_qe_torch.bench import matrix

    def host(t):
        return t.cpu().numpy()

    n = 1 << 24
    data = matrix.filter_agg_data(n, dev)
    res, _ = matrix.filter_agg_op(data, "radix")
    keys = data["key"].to_numpy()
    val = host(data["val"].view(torch.int32)).view(np.uint32)
    sel = val < (1 << 30)
    order = np.argsort(keys[sel], kind="stable")
    sk_, sv = keys[sel][order], val[sel][order].astype(np.uint64)
    starts = np.flatnonzero(np.r_[True, sk_[1:] != sk_[:-1]])
    ng = int(res.num_groups)
    if ng != len(starts):
        fail(f"filter_agg oracle: {ng} groups, numpy {len(starts)}")
    checks = {
        "keys": np.array_equal(res.key.to_numpy()[:ng], sk_[starts]),
        "counts": np.array_equal(host(res.aggs["count"])[:ng],
                                 np.diff(np.r_[starts, len(sk_)])),
        "sums": np.array_equal(res.aggs["sum"].to_numpy()[:ng],
                               np.add.reduceat(sv, starts)),
    }
    jd = matrix.join_data(n, dev)
    out, matched = matrix.join_op(jd, "radix")
    rkeys, lkeys = jd["rkey"].to_numpy(), jd["lkey"].to_numpy()
    rval = host(jd["rval"].view(torch.int32)).view(np.uint32)
    rorder = np.argsort(rkeys, kind="stable")
    pos = np.minimum(np.searchsorted(rkeys[rorder], lkeys), n - 1)
    hit = rkeys[rorder][pos] == lkeys
    checks["join_matched"] = np.array_equal(host(matched), hit)
    checks["join_values"] = np.array_equal(
        host(out["rval"].view(torch.int32)).view(np.uint32),
        np.where(hit, rval[rorder][pos], 0))
    if not all(checks.values()):
        fail(f"operators differ from the numpy oracle at 2^24 rows: {checks}")
    del data, res, jd, out, matched
    log(f"[10/10] operators: bench-matrix bit-exact across backends at full "
        f"size, launches as planned; numpy oracle at 2^24 rows "
        f"{json.dumps(checks)}; {time.perf_counter() - t0:.1f} s")

    src = "tpu_qe_torch/csrc/"
    summary = [
        ("block_histogram", src + "radix.cu",
         "tpu_qe/kernels/histogram.py:85"),
        ("exclusive_scan", src + "scan.cu", "tpu_qe/kernels/scan.py:69"),
        ("block_rank_and_histogram", src + "radix.cu",
         "tpu_qe/kernels/histogram.py:164"),
        ("rank_and_scatter", src + "radix.cu",
         "tpu_qe/kernels/histogram.py:164"),
        ("encode_quantized_lut", src + "morton.cu",
         "tpu_qe/kernels/morton.py:80"),
        ("sort_chunks", src + "bitonic.cu", "tpu_qe/kernels/bitonic.py:86"),
        ("block_rank_and_histogram_mxu", src + "rank_mxu.cu",
         "tpu_qe/kernels/rank_mxu.py:106"),
    ]
    rows = [
        {"name": name, "route": "cuda", "source": source, "replaces": rep,
         "launches": launches[name],
         "launch_path": ("selfcheck" if name in off_path else
                         "verify 8x8 + encode(use_lut, quirk_lut) + "
                         "bench-matrix"),
         "max_abs_err": err[name],
         "ms": ms[name][0], "plain_ms": ms[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": lib_ms[name]}
        for name, source, rep in summary]
    rows[1]["launch_floor_ms"] = floor_ms    # under exclusive_scan's bound
    # B1 and B3's rank mode at 9..16-bit digits take other kernels: their
    # times and byte bounds at 11 and 16 bits, 2^24 keys
    for row in (rows[0], rows[2]):
        row["wide"] = {
            f"{bits}bit": {"ms": wide_ms[(row["name"], bits)][0],
                           "plain_ms": wide_ms[(row["name"], bits)][1],
                           "bound_ms": wide_bounds[(row["name"], bits)][0],
                           "bound_by": wide_bounds[(row["name"], bits)][1]}
            for bits in (11, 16)}
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
