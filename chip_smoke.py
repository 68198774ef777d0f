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
   filter + GROUP BY and the join at 2^24 rows bit-exact against numpy;
11. quantile and window: `bench-matrix` through the CLI at full size
   (2^27 rows) for window (two rows) and quantile, bit-exact across
   backends, B1-B3 launched once per recorded pass; then at 2^22 rows
   against numpy: group DISC and CONT p50 / p99, window row_number, rank,
   dense_rank, exact running_sum and moving_sum(4 back, 3 ahead), and a
   bounded range_sum over an int32 order that spans zero (per-partition
   sort and binary searches in numpy);
12. the out-of-core sort: `bench-big` through the CLI at 2^30 keys
   (partition, merge, in-core) and with 3 payload columns at 2^28, every
   certificate true and B1-B3 launched once per recorded pass;
   sort_big(2^22, collect=True) against numpy's stable sort; a run
   killed mid-merge (from consume, at the third of four buckets, at 2^28)
   resumed from --checkpoint-dir with the whole run's per-bucket scalars;
13. the out-of-core operators through their CLIs at the JAX CLI's default
   sizes: bench-bigagg (2^30 rows, 2^20 groups, runs of 2^26; --minmax;
   --value-cols 4 at 2^28), bench-bigjoin 2^29 x 2^29 and --outer (full),
   bench-bigpipe, bench-bigtopk (and --largest), bench-bigdistinct and
   bench-bigsetops (union, intersect, except), every check true and B1-B3
   launched once per recorded pass; then with collect=True against numpy:
   aggregate_big at 2^22 rows, join_big and join_big_outer(full) at 2^21 x
   2^21, count_distinct_big and set_op_big at 2^22; then a bench-bigjoin
   process stopped from consume at its third of four buckets and a
   bench-bigagg process stopped after two of four run tables, each
   resumed through the CLI from --checkpoint-dir;
14. the last single-device out-of-core operators through their CLIs at
   the JAX CLI's default sizes: bench-bigquantile (2^30 keys, 16 runs) and
   --cont, bench-bigwindow (2^29 rows, 2^19 partitions, 8 runs, 8 buckets)
   and bench-bigorderby (2^30 rows, a_card 2^22, 16 runs, 16 buckets),
   every check true and B1-B3 launched once per recorded pass; then with
   collect=True against numpy at 2^22 rows: window_big with 1 and 2^12
   partitions (lexsort and the sequential recurrences, vectorised),
   order_by_big with a_card 7 (lexsort) and quantile_big with key_bits 64
   and 8 (numpy's sort of the regenerated keys); then a bench-bigwindow
   process stopped after two of four buckets were recorded and resumed
   through the CLI from --checkpoint-dir;
15. the SQL tier (tpu_qe_torch.sql.Database) with torch.sort, argsort and
   unique made to raise: `python -m tpu_qe_torch.bench.sql`'s run at its
   defaults (2^27 rows, 4096 groups; the SQL time, the hand-composed
   operators' time and the peak memory), its group table (count, sum,
   min, max) against numpy over the generated columns read back; an FK
   join + GROUP BY through SQL, inner and LEFT, of 2^24 rows against 2^22
   unique keys with half of the rows matched, against numpy; the family
   battery of tests/sql_battery.py on the card, integers bit-equal to the same
   battery on the CPU (floats within rtol 1e-5) and held to sqlite3; B1-B3
   launched once per recorded pass in each;
16. the out-of-core SQL tier (virtual tables, sql/bigexec.py), again with
   torch.sort, argsort and unique made to raise: `bench-bigsql` for each
   of its ten verbs (groupby, orderby, head, distinct, countdistinct,
   join, window, setops, range, vvjoin) at the JAX CLI's defaults (2^30
   rows, runs of 2^26, 2^16 groups; vvjoin 2^29 x 2^27) and groupby with
   --median and with --where, each holding its closed form, with its
   time, rows/s, peak memory and sort passes; then the virtual-table
   families of tests/sql_big_battery.py on the card, integers bit-equal
   to the CPU run's (floats within rtol 1e-5, atol 1e-3); B1-B3 launched
   once per recorded pass in each (head sorts nothing and launches none);
17. the exchange layer on a mesh of shards (exchange/mesh.py): `bench-matrix
   --configs dsort` through the CLI at 2^26 Zipf-ish keys on the default
   mesh (one shard per card) and with --devices 8 (a LocalMesh of 8 shards
   on the card), bit-exact across the radix and torch backends with every
   invariant true, with its time, rows/s, peak memory, passes, devices and
   balance; then with torch.sort, argsort and unique made to raise, on a
   LocalMesh of 8: distributed_sort_numpy at 2^24 keys with every 7th key a
   duplicate, at capacity_factor "auto" and at 3.0 with overlap=2 (both
   equal to numpy's stable argsort and to each other), and the reversal
   route at capacity_factor 1.0, which must raise the capacity error;
   sorted_morton_index_distributed over 2^24 points at overlap 1 and 2,
   bit-equal to encode_points + sort_u64 on the card; the dops family at
   2^22 rows against numpy (join_fk with a hot key, join_inner, join_outer
   full, top_k and largest, aggregate count / sum / min / max over u32 and
   f32 values (f32 sums within rtol 1e-5, atol 1e-3), count_distinct,
   join_aggregate with a hot key, set_op union / intersect / except); a
   GroupMesh over NCCL at world size 1 (its all_gather, all_to_all and pmax
   equal a LocalMesh of 1's; distributed_sort_numpy at 2^22 keys); B1-B3
   launched once per recorded pass in each. A LocalMesh time is one card
   doing every shard's work, its all_to_all a copy in the card's memory;
18. the rest of the exchange layer and the distributed out-of-core sort,
   torch.sort / argsort / unique made to raise, on a LocalMesh of 8: the
   reference dry run's window (rn, rank, running_sum, lag), ORDER BY (k
   desc, b) and quantile steps (five global quantiles, the group median
   over 37 partitions with max_groups 64, CONT (3, 2)) at its own size
   (8 x 8192 rows, its generators, seed 7), bit-equal to numpy and to the
   local operators on the card; then at 2^27 rows (the dry run's
   generators scaled) distributed_window (rn, rank, running_sum, lag, lag
   at offset 3, moving_sum(4), range_sum), distributed_order_by of three
   columns, distributed_quantile of 2^27 u64 values and
   distributed_group_quantile over the 37 groups, each bit-equal to the
   local operator on the card, with its time (CUDA events after an
   untimed warm-up), rows/s, peak memory, sort passes and balance; then
   `bench-big --distributed --devices 8` at 2^30 keys (runs of 2^26) and
   `--devices 1 --force-composed` at 2^28 through the CLI, every
   certificate true; sort_big_distributed(2^22, run_size=2^18,
   collect=True) against numpy's stable sort; a process stopped once its
   first bucket round was recorded, resumed through the CLI from
   --checkpoint-dir with every shard's per-bucket scalars identical to a
   whole run's; and a GroupMesh over NCCL at world size 1 whose psum (and
   distributed quantile) equal a LocalMesh of 1's; B1-B3 launched once
   per recorded pass in each;
19. the distributed out-of-core operators (ops/dbig*.py), torch.sort /
   argsort / unique made to raise, on a LocalMesh of 8: the reference dry
   run's out-of-core steps at its own size (8 shards x 2 runs x 2048 rows,
   its generators, seed 7) against its numpy oracles (GROUP BY with min /
   max, the FK join's match count, the window's row_number and exact
   running sum, the median and p99, the top 64, INTERSECT), and
   COUNT(DISTINCT), the fused join -> GROUP BY and ORDER BY at the same
   size against numpy; then the nine CLIs with --distributed --devices 8
   at the JAX CLI's default sizes (bench-bigagg 2^30 rows and 2^20 groups,
   bench-bigjoin and bench-bigpipe 2^29 x 2^29, bench-bigtopk 2^30 with
   k 1024 and --largest, bench-bigdistinct 2^30, bench-bigsetops 2^29 +
   2^29 for union, intersect and except, bench-bigquantile 2^30 and
   --cont, bench-bigwindow 2^29, bench-bigorderby 2^30; runs of 2^26),
   every check true, with each one's time, rows/s, peak memory, sort
   passes and balance; bench-bigagg and bench-bigjoin with --devices 1
   --force-composed at 2^28; a bench-bigagg --distributed process stopped
   after one of two round tables and a bench-bigjoin --distributed process
   stopped after one of two bucket rounds, each resumed through the CLI
   from --checkpoint-dir and equal to an uninterrupted run; a GroupMesh
   over NCCL at world size 1 whose composed GROUP BY equals LocalMesh(1)'s;
   B1-B3 launched once per recorded pass in each;
20. the SQL executor's mesh= path (Database.sql / explain over a LocalMesh
   of 8 shards on the card), torch.sort / argsort / unique made to raise:
   bench.sql's query (tools/bench_sql.py: filter + GROUP BY with COUNT,
   SUM, MIN and MAX, ORDER BY the group) at 2^27 rows and 4096 groups
   made on the card, bit-equal to the in-core Database.sql, with its
   seconds after an untimed warm-up (host clock fenced by synchronize),
   the share of them spent reading the registered columns back to the
   host (_dist_table), its peak memory and B1-B3 launches; then every
   query family of tests/sql_dist_battery.py (the set ops with and without
   ALL, GROUP BY over one to three columns with every aggregate,
   COUNT(DISTINCT) of u32 and u64 values, HAVING, the percentiles, SELECT
   DISTINCT, JOIN + GROUP BY against 2^20 unique right keys, the windows,
   ORDER BY with LIMIT / OFFSET, WHERE and a DESC float key, the zero-row
   GROUP BY) at 2^22 rows, and the reference's own-table cases, against
   the in-core answer (integers bit for bit, floats at the family's rtol,
   atol 1e-3), explain naming the distributed tier; a GroupMesh over NCCL
   at world size 1 whose GROUP BY equals LocalMesh(1)'s; B1-B3 launched
   once per recorded pass in each.

Then it prints the kernel summary as one JSON line (per kernel: launches on
the main path and the paths of phases 10-20, largest difference from its
references, its time, its plain twin's, the least time the card could
take for the same bytes or operations, and the time of the one PyTorch
call that computes the same function, where there is one), the
nvidia-smi line, and last the result line. Any failure exits nonzero;
without CUDA, or outside the repository, it exits nonzero before printing
a result.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
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
    log(f"[1/20] device: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} card(s)")

    # -- 2. build
    t0 = time.perf_counter()
    kernels.library()
    t1 = time.perf_counter()
    native.pipeline_oracle(10, 10, 7)
    t2 = time.perf_counter()
    log(f"[2/20] build: CUDA kernels {t1 - t0:.1f} s, C++ core {t2 - t1:.1f} s")

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
    log("[3/20] radix kernels bit-exact against twins and C++ oracles; "
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
    log("[4/20] B4, B5, B6 bit-exact against twins and oracles; max_abs_err "
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
    log("[5/20] main path: VERIFY PASS at 2^24 triangles for 8x8, 6x11 "
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
    log(f"[6/20] LUT encode path: B4 bit-exact on the verify scene; encode "
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
    log("[7/20] selfcheck: SELFCHECK PASS")

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
    log(f"[8/20] bench-kernels at 2^24: launches {counts}")

    # -- 9. headline sort
    res = headline.measure(1 << 26, seed=7, iters=10, device="cuda")
    log(f"      {json.dumps(res)}")
    if not res["verified"]:
        fail("radix sort of 2^26 keys differs from stable torch.sort")
    log(f"[9/20] headline: radix {res['time_s'] * 1e3:.3f} ms, torch.sort "
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
    log(f"[10/20] operators: bench-matrix bit-exact across backends at full "
        f"size, launches as planned; numpy oracle at 2^24 rows "
        f"{json.dumps(checks)}; {time.perf_counter() - t0:.1f} s")

    # -- 11. quantile and window: bench-matrix at full size, numpy oracles
    t0 = time.perf_counter()
    from tpu_qe_torch.sort import driver
    path_launches = {name: 0 for name in kernels.LAUNCHES}

    def counted(what: str, planned_from, fn, sorts: bool = True):
        """Drive one path with every count at 0 before it; B1, B2 and B3
        must have launched once per LSD pass its sorts planned (a path
        with sorts=False sorts nothing, and launches none)."""
        kernels.reset_launches()
        driver.RADIX_PASSES.clear()
        out = fn()
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        planned = planned_from(out)
        for name in ("block_histogram", "exclusive_scan",
                     "rank_and_scatter"):
            if (planned < 1) == sorts or counts[name] != planned:
                fail(f"{what}: {name} launched {counts[name]} times, the "
                     f"sorts planned {planned} passes")
        for name in path_launches:
            path_launches[name] += counts[name]
        return out, counts, planned

    def passes_recorded(_):
        return sum(driver.RADIX_PASSES.values())

    def cli_rows(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli(argv)
        rows = [json.loads(line) for line in buf.getvalue().splitlines()
                if line.startswith("{")]
        if rc != 0 or not rows:
            fail(f"{' '.join(argv)}: rc {rc}, {len(rows)} rows")
        return rows

    for configs in ("window", "quantile"):
        rows, counts, planned = counted(
            f"bench-matrix {configs}",
            lambda rows: sum(r["sort_passes"] * r["radix_runs"]
                             for r in rows),
            lambda: cli_rows(["bench-matrix", "--configs", configs]))
        for row in rows:
            log(f"      {json.dumps(row)}")
        log(f"      {configs} (2^27 rows): radix and torch backends "
            f"bit-exact, invariants hold; launches {counts} = planned "
            f"passes {planned}")
        torch.cuda.empty_cache()

    from tpu_qe_torch.ops.quantile import (canon_qs, group_quantile,
                                           group_quantile_cont)
    from tpu_qe_torch.ops.window import window
    n = 1 << 22
    qd = matrix.quantile_data(n, dev)
    disc, _, _ = counted("group_quantile at 2^22", passes_recorded,
                         lambda: group_quantile(qd["key"], qd["val"],
                                                matrix.QUANTILES))
    cont = group_quantile_cont(qd["key"], qd["val"], matrix.QUANTILES,
                               max_groups=qd["groups"])
    keys = qd["key"].to_numpy()
    val = host(qd["val"].view(torch.int32)).view(np.uint32)
    order = np.lexsort((val, keys))
    sk_, sv = keys[order], val[order]
    starts = np.flatnonzero(np.r_[True, sk_[1:] != sk_[:-1]])
    cnt = np.diff(np.r_[starts, n])
    ng = len(starts)
    checks = {"groups": int(disc.num_groups) == ng == int(cont.num_groups),
              "keys": np.array_equal(disc.key.to_numpy()[:ng], sk_[starts])
              and np.array_equal(cont.key.to_numpy()[:ng], sk_[starts])}
    for qi, (num, sh) in enumerate(canon_qs(matrix.QUANTILES)):
        r = np.clip(-((-num * cnt) >> sh) - 1, 0, cnt - 1)
        f = (num * (cnt - 1)) >> sh
        frac = (num * (cnt - 1)) & ((1 << sh) - 1)
        lower, upper = sv[starts + f], sv[starts + np.minimum(
            f + (frac != 0), cnt - 1)]
        lo_f = lower.astype(np.float32)
        value = lo_f + (upper.astype(np.float32) - lo_f) * (
            frac.astype(np.float32) * np.float32(1 / (1 << sh)))

        def got(t):
            return host(t[qi].view(torch.int32)).view(np.uint32)[:ng]
        checks[f"disc_q{qi}"] = np.array_equal(got(disc.quantiles),
                                               sv[starts + r])
        checks[f"cont_q{qi}"] = (
            np.array_equal(got(cont.lower), lower)
            and np.array_equal(got(cont.upper), upper)
            and np.array_equal(host(cont.frac[qi])[:ng], frac)
            and np.allclose(host(cont.value[qi])[:ng], value, rtol=1e-5,
                            atol=1e-3))
    del qd, disc, cont

    wd = matrix.window_data(n, dev)
    wd["order"] = (wd["order"].view(torch.int32) & 0x3F).view(torch.uint32)
    funcs = {"rn": ("row_number",), "rk": ("rank",), "dr": ("dense_rank",),
             "cum": ("running_sum", "v"), "ms": ("moving_sum", "v", 4, 3)}
    res, _, _ = counted("window at 2^22", passes_recorded,
                        lambda: matrix.window_op(wd, funcs, "radix"))
    keys = wd["key"].to_numpy()
    o = host(wd["order"].view(torch.int32)).view(np.uint32)
    v = host(wd["val"].view(torch.int32)).view(np.uint32).astype(np.uint64)
    perm = np.lexsort((o, keys))          # stable: ties by position
    sk_, so, sv = keys[perm], o[perm], v[perm]
    idx = np.arange(n)
    new = np.r_[True, sk_[1:] != sk_[:-1]]
    onew = new | np.r_[True, so[1:] != so[:-1]]
    ps = np.maximum.accumulate(np.where(new, idx, 0))
    pe = n - 1 - np.maximum.accumulate(
        np.where(np.r_[new[1:], True][::-1], idx, 0))[::-1]
    c = np.cumsum(onew)
    p0 = np.concatenate([np.zeros(1, np.uint64), np.cumsum(sv)])
    want = {"rn": idx - ps + 1,
            "rk": np.maximum.accumulate(np.where(onew, idx, 0)) - ps + 1,
            "dr": c - c[ps] + 1, "cum": p0[idx + 1] - p0[ps],
            "ms": p0[np.minimum(idx + 3, pe) + 1]
            - p0[np.maximum(idx - 3, ps)]}
    for name, w in want.items():
        col = res.cols[name]
        g = col.to_numpy() if isinstance(col, U64) else host(
            col.view(torch.int32)).view(np.uint32)
        inp = np.empty_like(w)
        inp[perm] = w
        checks[f"window_{name}"] = np.array_equal(g.astype(np.uint64),
                                                  inp.astype(np.uint64))
    # bounded RANGE over an int32 order that spans zero: the SQL frame by a
    # per-partition sort and binary searches in numpy
    oi = (o.astype(np.int64) % 41 - 20).astype(np.int32)
    res, _, _ = counted("bounded RANGE window at 2^22",
                        passes_recorded,
                        lambda: window(wd["key"],
                                       {"rb": ("range_sum", "v", 5)},
                                       order=torch.from_numpy(oi).to(dev),
                                       values={"v": wd["val"]}))
    perm = np.lexsort((oi, keys))
    sk_, so, sv = keys[perm], oi[perm].astype(np.int64), v[perm]
    part = np.cumsum(np.r_[True, sk_[1:] != sk_[:-1]]) - 1
    comp = (part << 32) | (so + (1 << 31))
    a = np.searchsorted(comp, (part << 32) | (np.maximum(
        so - 5, -(1 << 31)) + (1 << 31)), side="left")
    b = np.searchsorted(comp, comp, side="right")
    p0 = np.concatenate([np.zeros(1, np.uint64), np.cumsum(sv)])
    w = np.empty(n, np.uint64)
    w[perm] = p0[b] - p0[a]
    checks["window_range_sum_int32_order"] = np.array_equal(
        res.cols["rb"].to_numpy(), w)
    if not all(checks.values()):
        fail(f"quantile / window differ from numpy at 2^22 rows: {checks}")
    del wd, res
    torch.cuda.empty_cache()
    log(f"[11/20] quantile and window: bench-matrix bit-exact across "
        f"backends at 2^27 rows, launches as planned; numpy oracle at 2^22 "
        f"rows {json.dumps({k: bool(x) for k, x in checks.items()})}; "
        f"{time.perf_counter() - t0:.1f} s")

    # -- 12. the out-of-core sort: bench-big, a numpy oracle, a resume
    t0 = time.perf_counter()
    import os
    import tempfile

    from tpu_qe_torch.hashing import keygen_hash_numpy
    from tpu_qe_torch.sort import bigsort
    from tpu_qe_torch.utils.checkpoint import RunState

    for extra in (["--strategy", "partition"], ["--strategy", "merge"],
                  ["--in-core"], ["--payload-cols", "3", "--n",
                                  str(1 << 28)]):
        argv = ["bench-big", "--n", str(1 << 30)] + extra
        (row,), counts, planned = counted(" ".join(argv), passes_recorded,
                                          lambda: cli_rows(argv))
        log(f"      {json.dumps(row)}")
        if not (row["verified"] and all(row["checks"].values())):
            fail(f"{' '.join(argv)}: a certificate failed: {row}")
        log(f"      {' '.join(extra)}: every certificate holds; launches "
            f"{counts} = recorded passes {planned}")
        torch.cuda.empty_cache()

    n = 1 << 22
    res, (skeys, spay) = bigsort.sort_big(n, run_size=1 << 20, n_buckets=4,
                                          collect=True)
    want = keygen_hash_numpy(np.arange(n, dtype=np.uint32))
    order = np.argsort(want, kind="stable")
    if not (res.all_ok and np.array_equal(skeys, np.sort(want))
            and np.array_equal(spay, order.astype(np.uint32))):
        fail("sort_big(2^22, collect=True) differs from numpy.sort")
    log("      sort_big(2^22, run_size=2^20, 4 buckets, collect=True): "
        "keys and payloads equal numpy's stable sort")

    # a process killed mid-merge: consume exits with code 3 when the third
    # bucket has been merged, after the first two were recorded
    stopper = (
        "import os, sys\n"
        "from tpu_qe_torch.sort import bigsort\n"
        "def stop_at_the_third(b, bucket):\n"
        "    if b == 2:\n"
        "        os._exit(3)\n"
        "n, run_size, nb = (int(a) for a in sys.argv[2:])\n"
        "bigsort.sort_big(n, run_size=run_size, n_buckets=nb,\n"
        "                 checkpoint_dir=sys.argv[1],\n"
        "                 consume=stop_at_the_third)\n")
    n, run_size, nb = 1 << 28, 1 << 26, 4
    meta = np.asarray([n, run_size, nb, 7, 4096, 1, 1], np.int64)
    with tempfile.TemporaryDirectory() as full, \
            tempfile.TemporaryDirectory() as part_dir:
        whole = bigsort.sort_big(n, run_size=run_size, n_buckets=nb,
                                 checkpoint_dir=full)
        rc = subprocess.run([sys.executable, "-c", stopper, part_dir,
                             str(n), str(run_size), str(nb)],
                            timeout=600).returncode
        if rc != 3:
            fail(f"the run to stop at the third bucket exited with {rc}")
        stopped = RunState.load(part_dir, meta)
        if stopped is None or int(stopped.done.sum()) != 2:
            fail("the stopped run did not leave two buckets recorded")
        argv = ["bench-big", "--n", str(n), "--run-size", str(run_size),
                "--buckets", str(nb), "--checkpoint-dir", part_dir]
        (row,), counts, planned = counted("resumed bench-big",
                                          passes_recorded,
                                          lambda: cli_rows(argv))
        a, b = RunState.load(full, meta), RunState.load(part_dir, meta)
        if not (row["verified"] and whole.all_ok and b.done.all()
                and np.array_equal(a.scalars, b.scalars)
                and np.array_equal(a.bounds, b.bounds)):
            fail(f"the resumed run differs from the whole run: {row}")
    log(f"      resumed after two of {nb} buckets from --checkpoint-dir: "
        f"per-bucket scalars identical to the whole run's; launches "
        f"{counts} = recorded passes {planned}")
    for name in ("block_histogram", "exclusive_scan", "rank_and_scatter"):
        launches[name] += path_launches[name]
    log(f"[12/20] out-of-core sort: bench-big certificates at 2^30 "
        f"(partition, merge, in-core) and 2^28 with 3 payload columns, "
        f"numpy oracle, resume; {time.perf_counter() - t0:.1f} s")

    # -- 13. the out-of-core operators: their CLIs at the JAX CLI's default
    # sizes, numpy oracles with collect=True, resumes from a checkpoint
    t0 = time.perf_counter()
    for name in path_launches:
        path_launches[name] = 0
    from tpu_qe_torch.hashing import murmur_fmix32_numpy
    from tpu_qe_torch.ops import (bigagg, bigdistinct, bigjoin, bigouter,
                                  bigsetops)

    big_rows = []
    for argv in (["bench-bigagg"], ["bench-bigagg", "--minmax"],
                 ["bench-bigagg", "--value-cols", "4", "--n", str(1 << 28)],
                 ["bench-bigjoin"], ["bench-bigjoin", "--outer"],
                 ["bench-bigpipe"], ["bench-bigtopk"],
                 ["bench-bigtopk", "--largest"], ["bench-bigdistinct"],
                 ["bench-bigsetops", "--op", "union"],
                 ["bench-bigsetops", "--op", "intersect"],
                 ["bench-bigsetops", "--op", "except"]):
        (row,), counts, planned = counted(" ".join(argv), passes_recorded,
                                          lambda: cli_rows(argv))
        log(f"      {json.dumps(row)}")
        if not (row["verified"] and all(row["checks"].values())):
            fail(f"{' '.join(argv)}: a check failed: {row}")
        big_rows.append(row)
        log(f"      {' '.join(argv[1:]) or 'defaults'}: every check holds; "
            f"launches {counts} = recorded passes {planned}")
        torch.cuda.empty_cache()

    # collect=True against numpy
    checks = {}
    n, g, rs = 1 << 22, 1 << 12, 1 << 18
    res, table = counted("aggregate_big(2^22, collect=True)",
                         passes_recorded,
                         lambda: bigagg.aggregate_big(
                             n, n_groups=g, run_size=rs, collect=True))[0]
    idx = np.arange(n, dtype=np.uint32)
    gid = bigagg.group_of_index_numpy(idx, g)
    cnt = np.bincount(gid, minlength=g)
    sums = np.zeros(g, np.uint64)
    np.add.at(sums, gid, idx.astype(np.uint64))
    keep = cnt > 0
    checks["bigagg"] = bool(
        res.all_ok and np.array_equal(table["key"],
                                      np.flatnonzero(keep).astype(np.uint32))
        and np.array_equal(table["count"], cnt[keep].astype(np.uint32))
        and np.array_equal(table["sum"], sums[keep]))

    n = 1 << 21
    res, out = counted("join_big(2^21 x 2^21, collect=True)",
                       passes_recorded,
                       lambda: bigjoin.join_big(n, n, n_buckets=4,
                                                collect=True))[0]
    j = np.arange(n, dtype=np.uint32)
    rkeys = keygen_hash_numpy((j * np.uint32(2654435761)) % np.uint32(n))
    want_keys = np.where(j % 2 == 0, rkeys & ~np.uint64(1),
                         keygen_hash_numpy(j, 8) | np.uint64(1))
    keys, lidx = out["key"], out["lidx"]
    want_val = murmur_fmix32_numpy(
        (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        ^ (keys >> np.uint64(32)).astype(np.uint32) ^ np.uint32(0xABCD1234))
    checks["bigjoin"] = bool(
        res.all_ok and (keys[1:] >= keys[:-1]).all()
        and np.array_equal(np.sort(lidx), j)
        and np.array_equal(keys, want_keys[lidx])
        and np.array_equal(out["matched"], lidx % 2 == 0)
        and np.array_equal(out["value"],
                           np.where(out["matched"], want_val, 0)))

    res, out = counted("join_big_outer(2^21 x 2^21, full, collect=True)",
                       passes_recorded,
                       lambda: bigouter.join_big_outer(
                           n, n, how="full", n_buckets=4, collect=True))[0]
    keys, lidx, matched = out["key"], out["lidx"], out["matched"]
    checks["bigouter"] = bool(
        res.all_ok and (keys[1:] >= keys[:-1]).all()
        and np.array_equal(np.sort(lidx), j)
        and np.array_equal(keys, bigouter.lkeys_numpy(n, n)[lidx])
        and np.array_equal(matched, lidx % 2 == 0)
        and np.array_equal(out["value"], np.where(
            matched, bigouter.rval_numpy(keys), 0))
        and np.array_equal(np.sort(out["ro_ridx"]),
                           np.arange(1, n, 2, dtype=np.uint32)))

    n, g, v = 1 << 22, 1 << 10, 1 << 6
    res = counted("count_distinct_big(2^22, collect=True)", passes_recorded,
                  lambda: bigdistinct.count_distinct_big(
                      n, n_groups=g, n_values=v, run_size=1 << 20,
                      collect=True))[0]
    k_, v_ = bigdistinct.rows_of_index_numpy(np.arange(n), g, v)
    pairs = np.unique((k_.astype(np.uint64) << np.uint64(32)) | v_)
    checks["bigdistinct"] = bool(
        res.all_ok and np.array_equal(res.table["key"],
                                      np.arange(g, dtype=np.uint32))
        and np.array_equal(res.table["count_distinct"], np.bincount(
            (pairs >> np.uint64(32)).astype(np.int64), minlength=g))
        and np.array_equal(res.table["count"], np.bincount(k_,
                                                           minlength=g)))

    for op in ("union", "intersect", "except"):
        res = counted(f"set_op_big({op}, collect=True)", passes_recorded,
                      lambda: bigsetops.set_op_big(
                          op, 1 << 22, 1 << 22, g_a=3 << 12, g_b=1 << 13,
                          offset=1 << 12, run_size=1 << 20,
                          collect=True))[0]
        want = bigsetops.expected_result_numpy(op, 1 << 22, 3 << 12,
                                               1 << 22, 1 << 13, 1 << 12)
        checks[f"bigsetops_{op}"] = bool(res.all_ok and all(
            np.array_equal(res.table[c], w)
            for c, w in zip(("key", "count_a", "count_b"), want)))
    if not all(checks.values()):
        fail(f"the out-of-core operators differ from numpy: {checks}")
    log(f"      collect=True against numpy: {json.dumps(checks)}")

    # resumes: a bench-bigjoin process stopped from consume at its third
    # of four buckets (two recorded), a bench-bigagg process stopped after
    # two of four run tables, each resumed through the CLI
    stopper = (
        "import os, sys\n"
        "from tpu_qe_torch.ops import bigagg, bigjoin\n"
        "def stop_at_the_third(b, bucket):\n"
        "    if b == 2:\n"
        "        os._exit(3)\n"
        "save, saved = bigagg._run_ck_save, []\n"
        "def stop_after_two(*a):\n"
        "    save(*a)\n"
        "    saved.append(1)\n"
        "    if len(saved) == 2:\n"
        "        os._exit(3)\n"
        "bigagg._run_ck_save = stop_after_two\n"
        "n, run_size = int(sys.argv[3]), int(sys.argv[4])\n"
        "if sys.argv[1] == 'join':\n"
        "    bigjoin.join_big(n, n, n_buckets=4, checkpoint_dir=sys.argv[2],\n"
        "                     consume=stop_at_the_third)\n"
        "else:\n"
        "    bigagg.aggregate_big(n, run_size=run_size,\n"
        "                         checkpoint_dir=sys.argv[2])\n")
    n = 1 << 27
    meta = np.asarray([n, n, 4, 7, 8192], np.int64)
    with tempfile.TemporaryDirectory() as full, \
            tempfile.TemporaryDirectory() as part_dir:
        whole = bigjoin.join_big(n, n, n_buckets=4, checkpoint_dir=full)
        rc = subprocess.run([sys.executable, "-c", stopper, "join",
                             part_dir, str(n), "0"], timeout=600).returncode
        stopped = bigjoin._JoinState.load(part_dir, meta)
        if rc != 3 or stopped is None or int(stopped.done.sum()) != 2:
            fail(f"the join stopped at its third bucket exited with {rc} "
                 "and did not leave two buckets recorded")
        argv = ["bench-bigjoin", "--n-left", str(n), "--n-right", str(n),
                "--buckets", "4", "--checkpoint-dir", part_dir]
        (row,), counts, planned = counted("resumed bench-bigjoin",
                                          passes_recorded,
                                          lambda: cli_rows(argv))
        a = bigjoin._JoinState.load(full, meta)
        b = bigjoin._JoinState.load(part_dir, meta)
        if not (row["verified"] and whole.all_ok and b.done.all()
                and row["matched"] == whole.matched
                and np.array_equal(a.scalars, b.scalars)
                and np.array_equal(a.bounds, b.bounds)):
            fail(f"the resumed join differs from the whole run: {row}")
    log(f"      bench-bigjoin 2^27 x 2^27 resumed after two of 4 buckets: "
        f"per-bucket scalars identical to the whole run's; launches "
        f"{counts} = recorded passes {planned}")
    n, run_size = 1 << 28, 1 << 26
    with tempfile.TemporaryDirectory() as part_dir:
        rc = subprocess.run([sys.executable, "-c", stopper, "agg", part_dir,
                             str(n), str(run_size)], timeout=600).returncode
        tables = sorted(os.listdir(part_dir))
        if rc != 3 or tables != ["bigagg_run0.npz", "bigagg_run1.npz"]:
            fail(f"the GROUP BY stopped after two runs exited with {rc} "
                 f"and left {tables}")
        argv = ["bench-bigagg", "--n", str(n), "--run-size", str(run_size),
                "--checkpoint-dir", part_dir]
        (row,), counts, planned = counted("resumed bench-bigagg",
                                          passes_recorded,
                                          lambda: cli_rows(argv))
        _, got = bigagg.aggregate_big(n, run_size=run_size,
                                      checkpoint_dir=part_dir, collect=True)
        _, want = bigagg.aggregate_big(n, run_size=run_size, collect=True)
        if not (row["verified"] and all(np.array_equal(got[k], want[k])
                                        for k in want)):
            fail(f"the resumed GROUP BY differs from a whole run: {row}")
    log(f"      bench-bigagg 2^28 resumed with two of 4 run tables: every "
        f"check holds, the table equals a whole run's; launches {counts} "
        f"= recorded passes {planned}")
    for name in ("block_histogram", "exclusive_scan", "rank_and_scatter"):
        launches[name] += path_launches[name]
    log(f"[13/20] out-of-core operators: 12 CLI runs at the JAX CLI's "
        f"sizes, every check true and B1-B3 launched once per recorded "
        f"pass; numpy oracles; two resumes; "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"      phase 13 wall time: {time.perf_counter() - t0:.1f} s")

    # -- 14. the last single-device out-of-core operators: their CLIs at the
    # JAX CLI's default sizes, numpy oracles with collect=True, a resume
    t0 = time.perf_counter()
    for name in path_launches:
        path_launches[name] = 0
    from tpu_qe_torch.ops import bigorderby, bigquantile, bigwindow
    from tpu_qe_torch.ops.quantile import canon_qs, disc_rank

    for argv in (["bench-bigquantile"], ["bench-bigquantile", "--cont"],
                 ["bench-bigwindow"], ["bench-bigorderby"]):
        (row,), counts, planned = counted(" ".join(argv), passes_recorded,
                                          lambda: cli_rows(argv))
        log(f"      {json.dumps(row)}")
        if not (row["verified"] and all(row["checks"].values())):
            fail(f"{' '.join(argv)}: a check failed: {row}")
        big_rows.append(row)
        log(f"      {' '.join(argv)}: every check holds; launches {counts} "
            f"= recorded passes {planned}")
        torch.cuda.empty_cache()

    # collect=True against numpy
    checks = {}
    n = 1 << 22
    idx = np.arange(n, dtype=np.uint32)
    pos = np.arange(n)
    for parts in (1, 1 << 12):
        res, got = counted(f"window_big(2^22, {parts} partitions)",
                           passes_recorded,
                           lambda: bigwindow.window_big(
                               n, partitions=parts, run_size=1 << 20,
                               n_buckets=4, collect=True))[0]
        key, o, v = bigwindow.rows_numpy(idx, parts)
        perm = np.lexsort((idx, o, key))
        sk_, so, sv = key[perm], o[perm], v[perm].astype(np.uint64)
        new = np.r_[True, sk_[1:] != sk_[:-1]]
        onew = new | np.r_[True, so[1:] != so[:-1]]
        ps = np.maximum.accumulate(np.where(new, pos, 0))
        p0 = np.concatenate([np.zeros(1, np.uint64), np.cumsum(sv)])
        want = {"key": sk_, "order": so, "idx": perm, "value": sv,
                "rn": pos - ps + 1,
                "rk": np.maximum.accumulate(np.where(onew, pos, 0)) - ps + 1,
                "cum": p0[pos + 1] - p0[ps],
                "lg": np.where(new, 0, np.r_[0, sv[:-1]])}
        checks[f"bigwindow_{parts}"] = bool(res.all_ok and all(
            np.array_equal(got[k].astype(np.uint64), w.astype(np.uint64))
            for k, w in want.items()))

    res, got = counted("order_by_big(2^22, a_card 7)", passes_recorded,
                       lambda: bigorderby.order_by_big(
                           n, a_card=7, run_size=1 << 20, n_buckets=4,
                           collect=True))[0]
    a, b, pay = bigorderby.rows_numpy(idx, 7)
    perm = np.lexsort((idx, b, ~a))
    checks["bigorderby"] = bool(
        res.all_ok and np.array_equal(got["a"], a[perm])
        and np.array_equal(got["b"], b[perm])
        and np.array_equal(got["idx"], perm.astype(np.uint32))
        and np.array_equal(got["pay"], pay[perm]))

    qs = [0.0, 0.01, 0.25, 0.5, (3, 2), 0.99, 1.0]
    for key_bits in (64, 8):
        res = counted(f"quantile_big(2^22, key_bits {key_bits})",
                      passes_recorded,
                      lambda: bigquantile.quantile_big(
                          n, qs, run_size=1 << 20, key_bits=key_bits))[0]
        keys = keygen_hash_numpy(idx)
        if key_bits < 64:
            keys &= np.uint64((1 << key_bits) - 1)
        keys.sort()
        checks[f"bigquantile_{key_bits}"] = bool(
            res.all_ok and np.array_equal(res.values, np.array(
                [keys[disc_rank(num, sh, n)] for num, sh in canon_qs(qs)],
                dtype=np.uint64)))
    if not all(checks.values()):
        fail(f"window_big / order_by_big / quantile_big differ from numpy: "
             f"{checks}")
    log(f"      collect=True against numpy: {json.dumps(checks)}")

    # a bench-bigwindow process stopped after two of four buckets were
    # recorded, resumed through the CLI
    stopper = (
        "import os, sys\n"
        "from tpu_qe_torch.__main__ import main\n"
        "from tpu_qe_torch.utils.checkpoint import RunState\n"
        "record, done = RunState.record, []\n"
        "def stop_after_two(self, b, vals):\n"
        "    record(self, b, vals)\n"
        "    done.append(b)\n"
        "    if len(done) == 2:\n"
        "        os._exit(3)\n"
        "RunState.record = stop_after_two\n"
        "main(sys.argv[1:])\n")
    n = 1 << 28
    meta = np.asarray([n, n // 1024, 1 << 26, 4, 7, 4096, 0xB16], np.int64)
    with tempfile.TemporaryDirectory() as full, \
            tempfile.TemporaryDirectory() as part_dir:
        whole = bigwindow.window_big(n, n_buckets=4, checkpoint_dir=full)
        argv = ["bench-bigwindow", "--n", str(n), "--buckets", "4",
                "--checkpoint-dir", part_dir]
        rc = subprocess.run([sys.executable, "-c", stopper, *argv],
                            timeout=600).returncode
        stopped = RunState.load(part_dir, meta)
        if rc != 3 or stopped is None or int(stopped.done.sum()) != 2:
            fail(f"the bench-bigwindow process stopped after two buckets "
                 f"exited with {rc} and did not leave two buckets recorded")
        (row,), counts, planned = counted("resumed bench-bigwindow",
                                          passes_recorded,
                                          lambda: cli_rows(argv))
        a, b = RunState.load(full, meta), RunState.load(part_dir, meta)
        if not (row["verified"] and whole.all_ok and b.done.all()
                and np.array_equal(a.scalars, b.scalars)
                and np.array_equal(a.bounds, b.bounds)):
            fail(f"the resumed window differs from the whole run: {row}")
    log(f"      bench-bigwindow 2^28 resumed after two of 4 buckets: "
        f"per-bucket scalars and carries identical to the whole run's; "
        f"launches {counts} = recorded passes {planned}")
    for name in ("block_histogram", "exclusive_scan", "rank_and_scatter"):
        launches[name] += path_launches[name]
    log(f"[14/20] last out-of-core operators: 4 CLI runs at the JAX CLI's "
        f"sizes, every check true and B1-B3 launched once per recorded "
        f"pass; numpy oracles; a resume; {time.perf_counter() - t0:.1f} s")

    # -- 15. the SQL tier: bench.sql at its defaults, an FK join + GROUP BY
    # through SQL (inner and LEFT) and the family battery, against numpy
    # and sqlite3, with torch.sort / argsort / unique made to raise on the
    # card: no n-row sort leaves the radix kernels
    t0 = time.perf_counter()
    for name in path_launches:
        path_launches[name] = 0
    torch.cuda.empty_cache()
    from tpu_qe_torch.bench import sql as bsql
    from tpu_qe_torch.sql import Database
    from tpu_qe_torch.table import column_to_numpy
    spec = importlib.util.spec_from_file_location(
        "sql_battery", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "tests", "sql_battery.py"))
    sb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sb)
    cpu_battery = sb.battery(torch.device("cpu"))

    def refuse(*a, **k):
        raise AssertionError("an n-row sort left the radix kernels")
    saved = [(mod, name, getattr(mod, name)) for mod in (torch, torch.Tensor)
             for name in ("sort", "argsort", "unique")]
    for mod, name, _ in saved:
        setattr(mod, name, refuse)
    try:
        n, groups = 1 << 27, 4096
        (row, got, (key, v)), counts, planned = counted(
            "bench.sql at 2^27 rows", passes_recorded,
            lambda: bsql.run(n, groups, dev))
        log(f"      {json.dumps(row)}")
        k_np, v_np = column_to_numpy(key), column_to_numpy(v)
        keep = v_np % 4 != 0
        kk, vv = k_np[keep], v_np[keep]
        cnt = np.bincount(kk, minlength=groups)
        sums = np.bincount(kk, weights=vv, minlength=groups)
        mn = np.full(groups, np.iinfo(np.int32).max, np.int32)
        mx = np.full(groups, np.iinfo(np.int32).min, np.int32)
        np.minimum.at(mn, kk, vv)
        np.maximum.at(mx, kk, vv)
        present = np.flatnonzero(cnt)
        want = {"k": present.astype(np.uint32), "c": cnt[present],
                "s": sums[present].astype(np.int64), "mn": mn[present],
                "mx": mx[present]}
        bad = [c for c in want if not np.array_equal(got[c], want[c])]
        if not row["verified"] or bad:
            fail(f"bench.sql: the group table differs from numpy in {bad}"
                 f" (verified {row['verified']})")
        log(f"      bench.sql 2^27 rows -> {len(present)} groups: count, "
            f"sum, min, max equal numpy's; SQL {row['time_s']:.4f} s, "
            f"direct {row['direct_ops_time_s']:.4f} s, peak "
            f"{row['peak_mem_bytes'] / 1e9:.2f} GB; launches {counts} = "
            f"recorded passes {planned}")
        del key, v, k_np, v_np, kk, vv
        torch.cuda.empty_cache()

        # FK join + GROUP BY: t 2^24 rows, r 2^22 unique keys, half of t's
        # keys matched (r holds the even keys below 2^23)
        rng = np.random.default_rng(15)
        n_t, n_r, g_fk = 1 << 24, 1 << 22, 1024
        rk = rng.permutation(n_r).astype(np.uint32) * np.uint32(2)
        rw = rng.integers(-1000, 1000, n_r).astype(np.int32)
        tk = rng.integers(0, 2 * n_r, n_t).astype(np.uint32)
        tg = rng.integers(0, g_fk, n_t).astype(np.uint32)
        w_of = np.zeros(n_r, np.int64)
        w_of[rk // 2] = rw
        matched = tk % 2 == 0
        wt = np.where(matched, w_of[tk // 2], 0)
        db = Database(dev)
        db.register("t", {"k": tk, "g": tg})
        db.register("r", {"k": rk, "w": rw})
        fk = {
            "inner": ("SELECT g, COUNT(*) AS c, SUM(w) AS s FROM t JOIN r "
                      "ON t.k = r.k GROUP BY g ORDER BY g",
                      {"g": np.arange(g_fk, dtype=np.uint32),
                       "c": np.bincount(tg[matched], minlength=g_fk),
                       "s": np.bincount(tg, weights=wt, minlength=g_fk)}),
            "left": ("SELECT g, COUNT(*) AS c, SUM(w) AS s, "
                     "SUM(r__matched) AS m FROM t LEFT JOIN r "
                     "ON t.k = r.k GROUP BY g ORDER BY g",
                     {"g": np.arange(g_fk, dtype=np.uint32),
                      "c": np.bincount(tg, minlength=g_fk),
                      "s": np.bincount(tg, weights=wt, minlength=g_fk),
                      "m": np.bincount(tg, weights=matched,
                                       minlength=g_fk)})}
        fk_s = {}
        for how, (q, want) in fk.items():
            db.sql(q)       # first launches
            t1 = time.perf_counter()
            out, counts, planned = counted(f"SQL FK join ({how})",
                                           passes_recorded,
                                           lambda: db.sql(q))
            fk_s[how] = time.perf_counter() - t1
            bad = [c for c in want if not np.array_equal(
                out[c].astype(np.int64), want[c].astype(np.int64))]
            if list(out) != list(want) or bad:
                fail(f"SQL FK join ({how}) + GROUP BY differs from numpy "
                     f"in {bad or list(out)}")
            log(f"      FK join ({how}) 2^24 x 2^22 + GROUP BY through SQL:"
                f" equal numpy's; {fk_s[how]:.4f} s; launches {counts} = "
                f"recorded passes {planned}")
        del db
        torch.cuda.empty_cache()

        card_battery, counts, planned = counted(
            "the SQL family battery", passes_recorded,
            lambda: sb.battery(dev))
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    con = sb.sqlite_connection(sb.battery_tables())
    for fam, want in cpu_battery.items():
        bad = sb.differs(card_battery[fam], want)
        if bad is None and fam in sb.FAMILIES:
            q, sq, ordered = sb.FAMILIES[fam]
            bad = sb.agrees(card_battery[fam],
                            sb.sqlite_rows(con, sq or q), ordered)
        if bad is not None:
            fail(f"SQL family {fam} on the card: {bad}")
    log(f"      {len(cpu_battery)} SQL families on the card: integers "
        f"bit-equal to the CPU run's, floats within rtol 1e-5, sqlite3 "
        f"agrees; launches {counts} = recorded passes {planned}")
    for name in ("block_histogram", "exclusive_scan", "rank_and_scatter"):
        launches[name] += path_launches[name]
    log(f"[15/20] SQL tier: bench.sql at 2^27 rows and FK joins at 2^24 x "
        f"2^22 equal numpy's, {len(cpu_battery)} families equal the CPU "
        f"run's and sqlite3's, no torch.sort / argsort / unique, B1-B3 "
        f"launched once per recorded pass; {time.perf_counter() - t0:.1f} s")

    # -- 16. the out-of-core SQL tier over virtual tables: bench-bigsql's
    # ten verbs at the JAX CLI's defaults, groupby with --median and
    # --where, and the virtual-table families on the card against the CPU,
    # with torch.sort / argsort / unique made to raise on the card
    t0 = time.perf_counter()
    for name in path_launches:
        path_launches[name] = 0
    torch.cuda.empty_cache()
    spec = importlib.util.spec_from_file_location(
        "sql_big_battery", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "tests", "sql_big_battery.py"))
    bb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bb)
    cpu_big = bb.run(bb.database(torch.device("cpu")))
    from tpu_qe_torch.bench.bigsql import VERBS
    for mod, name, _ in saved:
        setattr(mod, name, refuse)
    try:
        for argv in ([["bench-bigsql", "--verb", v] for v in VERBS]
                     + [["bench-bigsql", "--median"],
                        ["bench-bigsql", "--where"]]):
            what = " ".join(argv[1:])
            (row,), counts, planned = counted(
                what, passes_recorded, lambda: cli_rows(argv),
                sorts=argv[-1] != "head")
            if not row["verified"]:
                fail(f"bench-bigsql {what}: the closed form does not hold: "
                     f"{row}")
            log(f"      {what}: {row['time_s']:.4f} s, "
                f"{row['value'] / 1e9:.4f} G rows/s, peak "
                f"{row['peak_mem_bytes'] / 1e9:.2f} GB, "
                f"{row['sort_passes']} sort passes"
                + "".join(f", {k[6:]} {row[k]:.4f} s" for k in row
                          if k.startswith("phase_"))
                + f"; launches {counts} = recorded passes {planned}")
            torch.cuda.empty_cache()
        card_big, counts, planned = counted(
            "the virtual-table families", passes_recorded,
            lambda: bb.run(bb.database(dev)))
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    for fam, want in cpu_big.items():
        bad = bb.differs(card_big[fam], want, bb.FAMILIES[fam][1])
        if bad is not None:
            fail(f"virtual-table family {fam} on the card: {bad}")
    log(f"      {len(cpu_big)} virtual-table families on the card: "
        f"integers bit-equal to the CPU run's, floats within rtol 1e-5 "
        f"(atol 1e-3); launches {counts} = recorded passes {planned}")
    for name in ("block_histogram", "exclusive_scan", "rank_and_scatter"):
        launches[name] += path_launches[name]
    log(f"[16/20] out-of-core SQL: bench-bigsql's ten verbs at 2^30 rows "
        f"(vvjoin 2^29 x 2^27), --median and --where, every closed form "
        f"holding; {len(cpu_big)} families equal the CPU run's; no "
        f"torch.sort / argsort / unique, B1-B3 launched once per recorded "
        f"pass; phase 16 {time.perf_counter() - t0:.1f} s")

    # -- 17. the exchange layer on a mesh of shards: bench-matrix dsort
    # (the default mesh and a LocalMesh of 8), then with torch.sort /
    # argsort / unique made to raise: the distributed sort, the
    # distributed pipeline and the dops family on a LocalMesh of 8
    # against numpy, and a GroupMesh over NCCL at world size 1
    t0 = time.perf_counter()
    for name in path_launches:
        path_launches[name] = 0
    torch.cuda.empty_cache()
    from tpu_qe_torch import morton as tmorton
    from tpu_qe_torch.exchange import (GroupMesh, LocalMesh, dops,
                                       distributed_sort_numpy, make_mesh)
    from tpu_qe_torch.pipeline import sorted_morton_index_distributed
    from tpu_qe_torch.sort import sort_u64
    # bench-matrix runs its torch backend (the torch.sort baseline) beside
    # the radix one, so its two runs come before the refusal
    for extra in ([], ["--devices", "8"]):
        argv = ["bench-matrix", "--configs", "dsort"] + extra
        (row,), counts, planned = counted(
            " ".join(argv), lambda rows: sum(r["sort_passes"] * r["radix_runs"]
                                             for r in rows),
            lambda: cli_rows(argv))
        if row["devices"] != (8 if extra else torch.cuda.device_count()):
            fail(f"{' '.join(argv)}: a mesh of {row['devices']}")
        log(f"      {' '.join(argv[1:])} (2^26 keys): radix "
            f"{row['time_s']:.4f} s, {row['value'] / 1e9:.4f} G rows/s (torch backend "
            f"{row['torch_time_s']:.4f} s), peak "
            f"{row['peak_mem_bytes'] / 1e9:.2f} GB, {row['sort_passes']} sort "
            f"passes, devices {row['devices']}, balance {row['balance']:.4f}, "
            f"backends bit-exact, checks {row['checks']}; launches {counts} "
            f"= recorded passes {planned}")
        torch.cuda.empty_cache()

    def same_rows(a, b, bits):
        """Equal multisets of rows given as column lists, each column's
        values below 2^bits (at most 64 bits in all): one packed sort."""
        def packed(cols):
            key = np.zeros(len(cols[0]), np.uint64)
            for c, w in zip(cols, bits):
                key = (key << np.uint64(w)) | c.astype(np.uint64)
            return np.sort(key)
        return np.array_equal(packed(a), packed(b))

    mesh = LocalMesh(8, dev)
    for mod, name, _ in saved:
        setattr(mod, name, refuse)
    try:
        n = 1 << 24
        rng = np.random.default_rng(7)
        keys = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
        keys[::7] = keys[0]                    # the dry run's duplicates
        pay = np.arange(n, dtype=np.uint32)
        order = np.argsort(keys, kind="stable")
        sorted_runs = []
        for label, kw in (("capacity_factor=auto",
                           {"capacity_factor": "auto"}),
                          ("capacity_factor=3, overlap=2",
                           {"capacity_factor": 3.0, "overlap": 2})):
            t1 = time.perf_counter()
            (k, p), counts, planned = counted(
                f"distributed_sort_numpy {label}", passes_recorded,
                lambda: distributed_sort_numpy(keys, pay, mesh, **kw))
            secs = time.perf_counter() - t1
            if not (np.array_equal(k, keys[order])
                    and np.array_equal(p, order.astype(np.uint32))):
                fail(f"distributed sort ({label}) differs from numpy's stable "
                     "argsort")
            sorted_runs.append((k, p))
            log(f"      distributed_sort_numpy 2^24 keys, LocalMesh(8), "
                f"{label}: equals numpy's stable argsort; {secs:.3f} s with "
                f"the host copies; launches {counts} = recorded passes "
                f"{planned}")
        if not all(np.array_equal(a, b) for a, b in zip(*sorted_runs)):
            fail("overlap=2 is not bit-identical to the monolithic exchange")
        try:
            distributed_sort_numpy(np.arange(n, 0, -1).astype(np.uint64), None,
                                   mesh, capacity_factor=1.0)
            fail("the reversal route at capacity_factor=1 did not overflow")
        except RuntimeError as e:
            if "capacity" not in str(e):
                fail(f"the reversal route raised {e!r}")
        del keys, pay, order, sorted_runs, k, p

        g = torch.Generator(device=dev).manual_seed(11)
        xyz = [torch.rand(n, generator=g, device=dev) * 100 - 50
               for _ in range(3)]
        params = tmorton.MortonParams.for_scene([-50.0] * 3, [50.0] * 3, dev)
        skey, (sidx,) = sort_u64(tmorton.encode_points(*xyz, params),
                                 torch.arange(n, dtype=torch.int32,
                                              device=dev))
        for ov in (1, 2):
            (res, ovf), counts, planned = counted(
                f"sorted_morton_index_distributed overlap={ov}",
                passes_recorded,
                lambda: sorted_morton_index_distributed(*xyz, params, mesh,
                                                        overlap=ov))
            valid = res.valid.tolist()
            got = [torch.cat([c[s, :v] for s, v in enumerate(valid)])
                   for c in (res.key.lo, res.key.hi, res.payloads[0])]
            if int(ovf.max()) or not all(torch.equal(a, b) for a, b in zip(
                    got, (skey.lo, skey.hi, sidx))):
                fail(f"the distributed pipeline (overlap={ov}) differs from "
                     "encode_points + sort_u64 on the card")
            log(f"      sorted_morton_index_distributed 2^24 points, "
                f"LocalMesh(8), overlap={ov}: bit-equal to encode_points + "
                f"sort_u64, valid {valid}; launches {counts} = recorded "
                f"passes {planned}")
        del xyz, skey, sidx, res, got
        torch.cuda.empty_cache()

        # the dops family at 2^22 rows against numpy
        n = 1 << 22
        rng = np.random.default_rng(23)
        n_r = 1 << 20
        rkeys = rng.permutation(np.unique(rng.integers(
            0, 1 << 40, 2 * n_r, dtype=np.uint64))[:n_r])
        rvals = rng.integers(0, 1 << 32, n_r, dtype=np.uint64).astype(
            np.uint32)
        pick = rng.integers(0, n_r, n)
        pick[: n // 3] = 0                     # the dry run's hot key
        miss = rng.random(n) < 0.5
        lkeys = rkeys[pick] | (miss.astype(np.uint64) << np.uint64(45))
        dkeys = rng.integers(0, 1 << 16, n).astype(np.uint64) << np.uint64(
            20)
        dvals = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
            np.uint32)
        fvals = rng.standard_normal(n).astype(np.float32)
        ikeys = rng.integers(0, n_r, n).astype(np.uint64)
        irkeys = rng.integers(0, n_r, n_r).astype(np.uint64)
        ivals = np.arange(n, dtype=np.uint32)
        irvals = np.arange(n_r, dtype=np.uint32) * 3
        ops_ok = {}

        def op(name, fn):
            return counted(name, passes_recorded, fn)[:2]

        t1 = time.perf_counter()
        (matched, (rv,)), _ = op("join_fk", lambda: (
            dops.distributed_join_fk_numpy(lkeys, [], rkeys, [rvals], mesh,
                                           capacity_factor="auto")))
        ops_ok["join_fk"] = (np.array_equal(matched, ~miss) and np.array_equal(
            rv[~miss], rvals[pick[~miss]]))

        # one-to-many joins: the oracle's (left row, right row) pairs from
        # the right side sorted by key
        rorder = np.argsort(irkeys, kind="stable")
        starts = np.searchsorted(irkeys[rorder], ikeys)
        cnt = np.searchsorted(irkeys[rorder], ikeys, side="right") - starts

        def pairs(c_out):
            offs = np.cumsum(c_out) - c_out
            li = np.repeat(np.arange(n), c_out)
            j = np.arange(int(c_out.sum())) - offs[li]
            ok = j < cnt[li]
            ri = rorder[np.minimum(starts[li] + j, n_r - 1)]
            return li, ok, np.where(ok, irvals[ri], 0)

        (g_i, (lv_i,), (rv_i,)), _ = op("join_inner", lambda: (
            dops.distributed_join_inner_numpy(ikeys, [ivals], irkeys,
                                              [irvals], mesh,
                                              capacity_factor="auto")))
        li, _, rvw = pairs(cnt)
        ops_ok["join_inner"] = (np.array_equal(lv_i, ivals[g_i])
                                and same_rows([g_i, rv_i], [li, rvw],
                                              (22, 22)))
        out_o, _ = op("join_outer (full)", lambda: (
            dops.distributed_join_outer_numpy(ikeys, [ivals], irkeys,
                                              [irvals], mesh, full=True,
                                              capacity_factor="auto")))
        li, ok, rvw = pairs(np.maximum(cnt, 1))
        ro = ~np.isin(irkeys, ikeys)
        ops_ok["join_outer"] = (
            np.array_equal(out_o[1][0], ivals[out_o[0]])
            and same_rows([out_o[0], out_o[2][0], out_o[3]], [li, rvw, ok],
                          (22, 22, 1))
            and same_rows([out_o[4], out_o[5][0]], [irkeys[ro], irvals[ro]],
                          (20, 22)))

        for largest in (False, True):
            (ks, gi, (vk,)), _ = op(f"top_k largest={largest}", lambda: (
                dops.distributed_top_k_numpy(dkeys, [dvals], mesh, 1000,
                                             largest=largest)))
            o = np.argsort(~dkeys if largest else dkeys,
                           kind="stable")[:1000]
            ops_ok[f"top_k largest={largest}"] = (
                np.array_equal(gi, o) and np.array_equal(ks, dkeys[o])
                and np.array_equal(vk, dvals[o]))

        # GROUP BY: rows in group order, each aggregate a reduceat
        ukeys, inv = np.unique(dkeys, return_inverse=True)
        o = np.argsort(inv, kind="stable")
        st = np.flatnonzero(np.r_[True, np.diff(inv[o]) != 0])
        for vals, is_f in ((dvals, False), (fvals, True)):
            got, _ = op(f"aggregate {'f32' if is_f else 'u32'}", lambda: (
                dops.distributed_aggregate_numpy(
                    dkeys, vals, mesh, aggs=("count", "sum", "min", "max"),
                    capacity_factor="auto")))
            sv = vals[o]
            want = {"count": np.diff(np.r_[st, n]),
                    "sum": np.add.reduceat(sv.astype(np.float64), st),
                    "min": np.minimum.reduceat(sv, st),
                    "max": np.maximum.reduceat(sv, st)}
            gk = np.array(sorted(got), dtype=np.uint64)
            ok = np.array_equal(gk, ukeys)
            for a, w in want.items():
                col = np.array([got[int(k)][a] for k in gk])
                ok = ok and (np.allclose(col, w, rtol=1e-5, atol=1e-3)
                             if is_f and a == "sum" else
                             np.array_equal(col, w.astype(col.dtype)))
            ops_ok[f"aggregate {'f32' if is_f else 'u32'}"] = ok

        cvals = dvals % np.uint32(97)
        got, _ = op("count_distinct", lambda: (
            dops.distributed_count_distinct_numpy(dkeys, cvals, mesh,
                                                  capacity_factor="auto")))
        pairs_u = np.unique(inv.astype(np.int64) * 97 + cvals)
        ops_ok["count_distinct"] = got == dict(zip(
            ukeys.tolist(), np.bincount(pairs_u // 97).tolist()))

        ja_rk = rkeys[: 1 << 16]
        ja_rv = rvals[: 1 << 16] >> np.uint32(16)
        ja_pick = rng.integers(0, 1 << 16, n)
        ja_pick[: n // 3] = 0                  # the dry run's hot key
        got, _ = op("join_aggregate", lambda: (
            dops.distributed_join_aggregate_numpy(rkeys[ja_pick], ja_rk,
                                                  ja_rv, mesh,
                                                  capacity_factor="auto")))
        cnt_ja = np.bincount(ja_pick, minlength=1 << 16)
        sum_ja = np.bincount(ja_pick, weights=ja_rv[ja_pick].astype(
            np.float64), minlength=1 << 16)
        ops_ok["join_aggregate"] = got == {
            int(ja_rk[i]): {"count": int(cnt_ja[i]), "sum": int(sum_ja[i])}
            for i in np.flatnonzero(cnt_ja)}

        sa = rng.integers(0, 1 << 22, n).astype(np.uint64) << np.uint64(9)
        sb = (rng.integers(0, 1 << 22, n // 2).astype(np.uint64)
              + np.uint64(1 << 21)) << np.uint64(9)
        for name, fn in (("union", np.union1d), ("intersect", np.intersect1d),
                         ("except", np.setdiff1d)):
            (k, ca, cb), _ = op(f"set_op {name}", lambda: (
                dops.distributed_set_op_numpy(sa, sb, mesh, op=name,
                                              capacity_factor="auto")))
            ua, na = np.unique(sa, return_counts=True)
            ub, nb = np.unique(sb, return_counts=True)
            want = fn(ua, ub)
            ia = np.minimum(np.searchsorted(ua, want), len(ua) - 1)
            ib = np.minimum(np.searchsorted(ub, want), len(ub) - 1)
            ops_ok[f"set_op {name}"] = (
                np.array_equal(k, want)
                and np.array_equal(ca, np.where(ua[ia] == want, na[ia], 0))
                and np.array_equal(cb, np.where(ub[ib] == want, nb[ib], 0)))
        dops_s = time.perf_counter() - t1
        bad = [k for k, ok in ops_ok.items() if not ok]
        if bad:
            fail(f"dops at 2^22 rows on LocalMesh(8) differ from numpy: {bad}")
        log(f"      dops family at 2^22 rows, LocalMesh(8): {len(ops_ok)} "
            f"operator runs equal numpy ({', '.join(ops_ok)}); {dops_s:.1f} s "
            f"with the oracles; B1-B3 launched once per recorded pass in "
            f"each")

        # a GroupMesh over NCCL at world size 1: its collectives on CUDA
        # tensors return what a LocalMesh of 1 returns
        import torch.distributed as tdist
        tdist.init_process_group("nccl", store=tdist.HashStore(), rank=0,
                                 world_size=1)
        try:
            gm, lm = make_mesh(), LocalMesh(1, dev)
            if not isinstance(gm, GroupMesh) or gm.n_dev != 1:
                fail(f"make_mesh() under a process group gave {gm}")
            x = torch.arange(1 << 20, dtype=torch.int32, device=dev)[None]
            v = torch.tensor([5], device=dev)
            if not (torch.equal(gm.all_gather(x), lm.all_gather(x))
                    and torch.equal(gm.all_to_all(x[:, None]),
                                    lm.all_to_all(x[:, None]))
                    and torch.equal(gm.pmax(v), lm.pmax(v))):
                fail("GroupMesh over NCCL differs from LocalMesh(1)")
            keys = rng.integers(0, 1 << 64, 1 << 22, dtype=np.uint64)
            pay = np.arange(1 << 22, dtype=np.uint32)
            (k, p), counts, planned = counted(
                "distributed_sort_numpy on a GroupMesh (NCCL)",
                passes_recorded,
                lambda: distributed_sort_numpy(keys, pay, gm))
            o = np.argsort(keys, kind="stable")
            if not (np.array_equal(k, keys[o]) and np.array_equal(p, o)):
                fail("distributed_sort_numpy on the NCCL GroupMesh differs "
                     "from numpy")
        finally:
            tdist.destroy_process_group()
        log(f"      GroupMesh over NCCL, world size 1: all_gather, "
            f"all_to_all and pmax equal LocalMesh(1)'s; distributed_sort_numpy"
            f" at 2^22 equals numpy; launches {counts} = recorded passes "
            f"{planned}")
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    for name in ("block_histogram", "exclusive_scan", "rank_and_scatter"):
        launches[name] += path_launches[name]
    log(f"[17/20] exchange layer: bench-matrix dsort at 2^26 on the default "
        f"mesh and a LocalMesh of 8, bit-exact across backends; the "
        f"distributed sort, pipeline and dops family on a LocalMesh of 8 "
        f"equal numpy; NCCL at world size 1; no torch.sort / argsort / "
        f"unique, B1-B3 launched once per recorded pass "
        f"({path_launches['block_histogram']} times each); phase 17 "
        f"{time.perf_counter() - t0:.1f} s")

    # -- 18. the rest of the exchange layer (dwindow, dorderby, dquantile)
    # and the distributed out-of-core sort, on a LocalMesh of 8 shards on
    # the card, with torch.sort / argsort / unique made to raise
    t0 = time.perf_counter()
    for name in path_launches:
        path_launches[name] = 0
    torch.cuda.empty_cache()
    from tpu_qe_torch.exchange import (distributed_group_quantile,
                                       distributed_group_quantile_numpy,
                                       distributed_order_by,
                                       distributed_order_by_numpy,
                                       distributed_quantile,
                                       distributed_quantile_numpy,
                                       distributed_window,
                                       distributed_window_numpy)
    from tpu_qe_torch.exchange.dorderby import (plan_order_by_capacity,
                                                shard_table)
    from tpu_qe_torch.exchange.dquantile import \
        distributed_quantile_cont_numpy
    from tpu_qe_torch.exchange.dsort import shard_column, shard_u64
    from tpu_qe_torch.exchange.dwindow import auto_window_capacity
    from tpu_qe_torch.exchange.shuffle import pow2_capacity
    from tpu_qe_torch.ops.orderby import sort_by_multi
    from tpu_qe_torch.ops.quantile import (canon_qs, cont_rank, disc_rank,
                                           group_quantile, quantile,
                                           quantile_cont)
    from tpu_qe_torch.ops.window import window
    from tpu_qe_torch.sort.dbigsort import (keygen_masked_numpy,
                                            sort_big_distributed)
    from tpu_qe_torch.table import Table, column_from_numpy, plane

    def np_window(k, o, v):
        """rn, rank, running_sum and lag (fill 3) by (key, order, row)
        in numpy, in input order."""
        n_ = len(k)
        perm = np.lexsort((np.arange(n_), o, k))
        sk_, so_, sv_ = k[perm], o[perm], v[perm].astype(np.uint64)
        new = np.r_[True, sk_[1:] != sk_[:-1]]
        run = new | np.r_[True, so_[1:] != so_[:-1]]
        i_ = np.arange(n_)
        ps = np.maximum.accumulate(np.where(new, i_, 0))
        rs = np.maximum.accumulate(np.where(run, i_, 0))
        cs = np.cumsum(sv_)
        cols = {"rn": (i_ - ps + 1).astype(np.uint32),
                "rk": (rs - ps + 1).astype(np.uint32),
                "cs": cs - (cs[ps] - sv_[ps]),
                "lg": np.where(new, 3, np.r_[0, v[perm][:-1]]).astype(
                    np.uint32)}
        out = {}
        for nm, c in cols.items():
            out[nm] = np.empty_like(c)
            out[nm][perm] = c
        return out

    def on_card_cols(res):
        """{name: numpy column} of a WindowResult / Table."""
        cols = res.cols if hasattr(res, "cols") else {
            nm: res[nm] for nm in res}
        return {nm: column_to_numpy(c) for nm, c in cols.items()}

    def step_timed(what, fn, valid_of=None, n_rows=None):
        """One untimed warm-up, then one counted run between CUDA events:
        (out, seconds, peak bytes, passes, launches)."""
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)

        def run():
            ev0.record()
            out = fn()
            ev1.record()
            return out
        out, counts, planned = counted(what, passes_recorded, run)
        secs = ev0.elapsed_time(ev1) / 1e3
        peak = torch.cuda.max_memory_allocated(dev)
        bal = (None if valid_of is None else
               int(valid_of(out).max()) / (n_rows / mesh.n_dev))
        log(f"      {what}: {secs:.4f} s, {n_rows / secs / 1e9:.4f} G rows/s, "
            f"peak {peak / 1e9:.2f} GB, {planned} sort passes, balance "
            f"{'n/a (no rows move)' if bal is None else f'{bal:.4f}'}; "
            f"launches {counts} = recorded passes {planned}")
        return out

    def prefixes(runs, valid):
        """The valid prefixes of (S, W) runs, concatenated."""
        return torch.cat([runs[s, :v] for s, v in enumerate(valid.tolist())])

    mesh = LocalMesh(8, dev)
    for mod, name, _ in saved:
        setattr(mod, name, refuse)
    try:
        # (a) the dry run's window, ORDER BY and quantile steps at its own
        # size and generators (__graft_entry__.dryrun_multichip, seed 7)
        n = 8 * 8192
        rng = np.random.default_rng(7)
        rng.integers(0, 1 << 64, size=n, dtype=np.uint64)   # its sort keys
        wkeys = rng.integers(0, 37, n).astype(np.uint64)
        worder = rng.integers(0, 1 << 20, n, dtype=np.uint32)
        wv = rng.integers(0, 1 << 32, n).astype(np.uint32)
        ja_rk = np.unique(rng.integers(0, 1 << 40, n // 2,
                                       dtype=np.uint64))[: n // 4]
        rng.integers(0, 1 << 16, len(ja_rk), dtype=np.int64)
        rng.integers(0, len(ja_rk), n)
        qvals = rng.integers(0, 1 << 64, n, dtype=np.uint64)
        dry = {}
        wfuncs = {"rn": ("row_number",), "rk": ("rank",),
                  "cs": ("running_sum", "v"), "lg": ("lag", "v", 3)}
        got, _, _ = counted("distributed_window_numpy (dry run)",
                            passes_recorded,
                            lambda: distributed_window_numpy(
                                wkeys, wfuncs, mesh, order=worder,
                                values={"v": wv}, capacity_factor="auto"))
        loc = on_card_cols(window(U64.from_numpy(wkeys, dev), wfuncs,
                                  order=column_from_numpy(worder, dev),
                                  values={"v": column_from_numpy(wv, dev)}))
        want = np_window(wkeys, worder, wv)
        dry["window"] = all(np.array_equal(got[k], want[k])
                            and np.array_equal(got[k], loc[k]) for k in want)
        ob_cols = {"k": wkeys, "b": wv.view(np.int32),
                   "i": np.arange(n, dtype=np.uint32)}
        ob_by = [("k", "desc"), "b"]
        (got, gpos), _, _ = counted(
            "distributed_order_by_numpy (dry run)", passes_recorded,
            lambda: distributed_order_by_numpy(ob_cols, ob_by, mesh,
                                               capacity_factor="auto"))
        loc = on_card_cols(sort_by_multi(Table.from_numpy(ob_cols, dev),
                                         ob_by))
        perm = np.lexsort((np.arange(n), ob_cols["b"], ~wkeys))
        dry["order_by"] = (np.array_equal(gpos, perm) and all(
            np.array_equal(got[k], c[perm]) and np.array_equal(got[k], loc[k])
            for k, c in ob_cols.items()))
        q_spec = [0.0, 0.25, (1, 1), 0.99, 1.0]
        got, _, _ = counted("distributed_quantile_numpy (dry run)",
                            passes_recorded,
                            lambda: distributed_quantile_numpy(qvals, q_spec,
                                                               mesh))
        s_q = np.sort(qvals)
        want = np.array([s_q[disc_rank(num, sh, n)]
                         for num, sh in canon_qs(q_spec)], dtype=np.uint64)
        dry["quantile"] = (np.array_equal(got, want) and np.array_equal(
            got, quantile(U64.from_numpy(qvals, dev), q_spec).to_numpy()))
        cd_vals = (wv % 17).astype(np.uint32)
        got, _, _ = counted(
            "distributed_group_quantile_numpy (dry run)", passes_recorded,
            lambda: distributed_group_quantile_numpy(wkeys, cd_vals, [(1, 1)],
                                                     mesh, max_groups=64))
        res = group_quantile(U64.from_numpy(wkeys, dev),
                             column_from_numpy(cd_vals, dev), [(1, 1)])
        ng = int(res.num_groups)
        loc = dict(zip(res.key.to_numpy()[:ng].tolist(),
                       column_to_numpy(res.quantiles)[0, :ng].tolist()))
        want = {}
        for k in np.unique(wkeys):
            sv_g = np.sort(cd_vals[wkeys == k])
            want[int(k)] = int(sv_g[(len(sv_g) + 1) // 2 - 1])
        dry["group_median"] = ({k: int(v[0]) for k, v in got.items()}
                               == want == loc)
        cq, _, _ = counted("distributed_quantile_cont_numpy (dry run)",
                           passes_recorded,
                           lambda: distributed_quantile_cont_numpy(
                               qvals, [(3, 2)], mesh))
        fq, cq_r, frq = cont_rank(3, 2, n)
        lcq = quantile_cont(U64.from_numpy(qvals, dev), [(3, 2)])
        dry["cont_3_2"] = (cq.lower.to_numpy()[0] == s_q[fq]
                           and cq.upper.to_numpy()[0] == s_q[cq_r]
                           and cq.frac_num[0] == frq
                           and np.array_equal(cq.lower.to_numpy(),
                                              lcq.lower.to_numpy())
                           and np.array_equal(cq.upper.to_numpy(),
                                              lcq.upper.to_numpy())
                           and cq.frac_num == lcq.frac_num)
        if not all(dry.values()):
            fail(f"the dry run's steps on LocalMesh(8) differ from numpy or "
                 f"the local operators: {dry}")
        log(f"      the dry run's window, ORDER BY, quantile, group median "
            f"and CONT (3, 2) at {n} rows on LocalMesh(8): bit-equal to "
            f"numpy and to the local operators on the card {dry}")
        del wkeys, worder, wv, qvals, cd_vals

        # (b) full width: 2^27 rows, the dry run's generators scaled
        n = 1 << 27
        rng = np.random.default_rng(7)
        bk = rng.integers(0, 37, n).astype(np.uint64)
        bo = rng.integers(0, 1 << 20, n, dtype=np.uint32)
        bv = rng.integers(0, 1 << 32, n).astype(np.uint32)
        key, order_t = shard_u64(bk, mesh), shard_column(bo, mesh)
        vals_t = {"v": shard_column(bv, mesh)}
        bfuncs = {"rn": ("row_number",), "rk": ("rank",),
                  "cs": ("running_sum", "v"), "lg": ("lag", "v", 3),
                  "lg3": ("lag", "v", 0, 3), "ms": ("moving_sum", "v", 4),
                  "rs": ("range_sum", "v", "unbounded")}

        def dwin():
            cap = auto_window_capacity(key, order_t, mesh)
            return distributed_window(key, bfuncs, mesh, order=order_t,
                                      values=vals_t, capacity=cap)
        res, ovf = step_timed("distributed_window 2^27 rows, 37 partitions, "
                              "7 functions, LocalMesh(8)", dwin,
                              lambda o: o[0].valid, n)
        if int(ovf.max()):
            fail("distributed_window at 2^27 overflowed its planned capacity")
        key_g = U64.from_numpy(bk, dev)
        loc = window(key_g, bfuncs, order=column_from_numpy(bo, dev),
                     values={"v": column_from_numpy(bv, dev)}).cols
        m = (torch.arange(res.pos.shape[1], device=dev)[None]
             < res.valid[:, None])
        p = res.pos[m]
        bad = []
        for nm, c in res.cols.items():
            for a, b in ((c.lo, loc[nm].lo), (c.hi, loc[nm].hi)) if \
                    isinstance(c, U64) else ((plane(c), plane(loc[nm])),):
                flat = torch.empty_like(b)
                flat[p] = a[m]
                if not torch.equal(flat, b):
                    bad.append(nm)
        if bad:
            fail(f"distributed_window at 2^27 differs from the local window "
                 f"on the card: {sorted(set(bad))}")
        del res, loc, m, p, flat
        torch.cuda.empty_cache()

        ob = {"k": bk, "b": bv.view(np.int32),
              "i": np.arange(n, dtype=np.uint32)}
        tab = shard_table(ob, mesh)

        def dob():
            cap = pow2_capacity(int(plan_order_by_capacity(tab, ob_by,
                                                           mesh).max()))
            return distributed_order_by(tab, ob_by, mesh, capacity=cap)
        st, _, valid, ovf = step_timed(
            "distributed_order_by 2^27 rows, 3 columns, LocalMesh(8)", dob,
            lambda o: o[2], n)
        want = sort_by_multi(Table.from_numpy(ob, dev), ob_by)
        ok = not int(ovf.max())
        for nm in ob:
            c, w = st[nm], want[nm]
            for a, b in ((c.lo, w.lo), (c.hi, w.hi)) if isinstance(
                    c, U64) else ((plane(c), plane(w)),):
                ok = ok and torch.equal(prefixes(a, valid), b)
        if not ok:
            fail("distributed_order_by at 2^27 differs from sort_by_multi")
        del st, want, tab
        torch.cuda.empty_cache()

        qv = rng.integers(0, 1 << 64, n, dtype=np.uint64)
        qcol = shard_u64(qv, mesh)
        got = step_timed("distributed_quantile 2^27 u64 values, 5 "
                         "quantiles, LocalMesh(8)",
                         lambda: distributed_quantile(qcol, q_spec, mesh),
                         None, n)
        want = quantile(U64.from_numpy(qv, dev), q_spec)
        if not (torch.equal(got.lo, want.lo) and torch.equal(got.hi,
                                                             want.hi)):
            fail("distributed_quantile at 2^27 differs from quantile")
        del qcol, qv
        gq = step_timed("distributed_group_quantile 2^27 rows, 37 groups, "
                        "p50 / p99, LocalMesh(8)",
                        lambda: distributed_group_quantile(
                            key, vals_t["v"], [(1, 1), 0.99], mesh,
                            max_groups=64), None, n)
        want = group_quantile(key_g, column_from_numpy(bv, dev),
                              [(1, 1), 0.99])
        ng = int(want.num_groups)
        if not (int(gq[3]) == ng == 37 and not int(gq[4])
                and torch.equal(gq[0].lo[:ng], want.key.lo[:ng])
                and torch.equal(gq[0].hi[:ng], want.key.hi[:ng])
                and torch.equal(plane(gq[1])[:, :ng],
                                plane(want.quantiles)[:, :ng])
                and torch.equal(gq[2][:ng], want.count[:ng])):
            fail("distributed_group_quantile at 2^27 differs from "
                 "group_quantile")
        del key, order_t, vals_t, key_g, want, gq, bk, bo, bv
        torch.cuda.empty_cache()
        log("      2^27 rows on LocalMesh(8): the window's 7 integer "
            "columns, the ORDER BY, the quantiles and the group quantiles "
            "bit-equal to the local operators on the card")

        # (c) the distributed out-of-core sort
        for extra in (["--devices", "8"],
                      ["--devices", "1", "--force-composed", "--n",
                       str(1 << 28)]):
            argv = ["bench-big", "--distributed"] + extra
            (row,), counts, planned = counted(" ".join(argv),
                                              passes_recorded,
                                              lambda: cli_rows(argv))
            log(f"      {json.dumps(row)}")
            if not (row["verified"] and all(row["checks"].values())
                    and row["metric"].startswith("distributed out-of-core")):
                fail(f"{' '.join(argv)}: a certificate failed: {row}")
            log(f"      {' '.join(extra)}: every certificate holds, "
                f"{row['time_s']:.4f} s, peak "
                f"{row['peak_mem_bytes'] / 1e9:.2f} GB, balance "
                f"{row['balance']:.4f}; launches {counts} = recorded passes "
                f"{planned}")
            torch.cuda.empty_cache()
        n = 1 << 22
        (res, (skeys, spay)), counts, planned = counted(
            "sort_big_distributed 2^22 collect", passes_recorded,
            lambda: sort_big_distributed(n, mesh, run_size=1 << 18,
                                         collect=True))
        want = keygen_masked_numpy(np.arange(n, dtype=np.uint32))
        order = np.argsort(want, kind="stable")
        if not (res.all_ok and np.array_equal(skeys, want[order])
                and np.array_equal(spay, order.astype(np.uint32))):
            fail("sort_big_distributed(2^22, collect=True) differs from "
                 "numpy's stable sort")
        log(f"      sort_big_distributed(2^22, LocalMesh(8), run_size=2^18, "
            f"collect=True): keys and payloads equal numpy's stable sort; "
            f"launches {counts} = recorded passes {planned}")
        # a process stopped once its first bucket round is recorded,
        # resumed through the CLI from --checkpoint-dir
        stopper = (
            "import os, sys\n"
            "from tpu_qe_torch.exchange import LocalMesh\n"
            "from tpu_qe_torch.sort import dbigsort\n"
            "from tpu_qe_torch.utils.checkpoint import RunState\n"
            "record = RunState.record\n"
            "def stop_after_the_first(self, b, vals):\n"
            "    record(self, b, vals)\n"
            "    os._exit(3)\n"
            "RunState.record = stop_after_the_first\n"
            "n, run_size = int(sys.argv[2]), int(sys.argv[3])\n"
            "dbigsort.sort_big_distributed(n, LocalMesh(8, 'cuda'),\n"
            "    run_size=run_size, buckets_per_dev=2,\n"
            "    checkpoint_dir=sys.argv[1])\n")
        n, run_size = 1 << 28, 1 << 24
        meta = np.asarray([n, 8, run_size, 2, 7, min(4096, run_size), 64,
                           1], np.int64)
        with tempfile.TemporaryDirectory() as full, \
                tempfile.TemporaryDirectory() as part_dir:
            whole = sort_big_distributed(n, mesh, run_size=run_size,
                                         buckets_per_dev=2,
                                         checkpoint_dir=full)
            rc = subprocess.run([sys.executable, "-c", stopper, part_dir,
                                 str(n), str(run_size)],
                                timeout=600).returncode
            if rc != 3:
                fail(f"the run to stop after its first bucket round exited "
                     f"with {rc}")
            stopped = RunState.load(part_dir, meta)
            if stopped is None or int(stopped.done.sum()) != 1:
                fail("the stopped run did not leave one bucket round "
                     "recorded")
            argv = ["bench-big", "--distributed", "--devices", "8", "--n",
                    str(n), "--run-size", str(run_size), "--buckets", "2",
                    "--checkpoint-dir", part_dir]
            (row,), counts, planned = counted("resumed bench-big "
                                              "--distributed",
                                              passes_recorded,
                                              lambda: cli_rows(argv))
            a, b = RunState.load(full, meta), RunState.load(part_dir, meta)
            if not (row["verified"] and whole.all_ok and b.done.all()
                    and np.array_equal(a.scalars, b.scalars)
                    and np.array_equal(a.bounds, b.bounds)):
                fail(f"the resumed distributed run differs from the whole "
                     f"run: {row}")
        log(f"      bench-big --distributed resumed after one of two bucket "
            f"rounds from --checkpoint-dir (2^28 keys, runs of 2^24): every "
            f"shard's per-bucket scalars identical to the whole run's; "
            f"launches {counts} = recorded passes {planned}")

        # (d) a GroupMesh over NCCL at world size 1: psum
        import torch.distributed as tdist
        tdist.init_process_group("nccl", store=tdist.HashStore(), rank=0,
                                 world_size=1)
        try:
            gm, lm = make_mesh(), LocalMesh(1, dev)
            v = torch.tensor([[5, 1 << 40, -7]], device=dev)
            qv = rng.integers(0, 1 << 64, 1 << 20, dtype=np.uint64)
            if not (isinstance(gm, GroupMesh)
                    and torch.equal(gm.psum(v), lm.psum(v))
                    and np.array_equal(
                        distributed_quantile_numpy(qv, q_spec, gm),
                        distributed_quantile_numpy(qv, q_spec, lm))):
                fail("GroupMesh psum over NCCL differs from LocalMesh(1)")
        finally:
            tdist.destroy_process_group()
        log("      GroupMesh over NCCL, world size 1: psum and "
            "distributed_quantile_numpy at 2^20 equal LocalMesh(1)'s")
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    for name in ("block_histogram", "exclusive_scan", "rank_and_scatter"):
        launches[name] += path_launches[name]
    log(f"[18/20] the rest of the exchange layer and the distributed "
        f"out-of-core sort: the dry run's window, ORDER BY and quantile "
        f"steps and the same at 2^27 rows on a LocalMesh of 8 equal numpy "
        f"and the local operators; bench-big --distributed at 2^30 and "
        f"--force-composed at 2^28 certified, 2^22 equal to numpy, a "
        f"resume; psum over NCCL; no torch.sort / argsort / unique, B1-B3 "
        f"launched once per recorded pass "
        f"({path_launches['block_histogram']} times each); phase 18 "
        f"{time.perf_counter() - t0:.1f} s")

    # -- 19. the distributed out-of-core operators (ops/dbig*.py) on a
    # LocalMesh of 8 shards on the card, torch.sort / argsort / unique made
    # to raise: the dry run's steps, the nine CLIs with --distributed, two
    # --force-composed runs at D = 1, two resumes, a GroupMesh over NCCL
    t0 = time.perf_counter()
    for name in path_launches:
        path_launches[name] = 0
    torch.cuda.empty_cache()
    from tpu_qe_torch.ops import bigdistinct as b_dist
    from tpu_qe_torch.ops import bigorderby as b_ob
    from tpu_qe_torch.ops import bigpipe as b_pipe
    from tpu_qe_torch.ops import bigwindow as b_win
    from tpu_qe_torch.ops import (dbigagg, dbigdistinct, dbigjoin,
                                  dbigorderby, dbigpipe, dbigquantile,
                                  dbigsetops, dbigtopk, dbigwindow)

    mesh = LocalMesh(8, dev)
    dist_rows = []
    for mod, name, _ in saved:
        setattr(mod, name, refuse)
    try:
        # (a) the reference dry run's out-of-core steps at its own size
        # (__graft_entry__.dryrun_multichip: 8 shards x 2 runs x 2048 rows,
        # seed 7), each against the numpy oracle the dry run uses
        run, dry = 2048, {}
        n = 8 * 2 * run
        idx = np.arange(n, dtype=np.uint32)
        (res, tbl), _, _ = counted(
            "dbigagg (dry run)", passes_recorded,
            lambda: dbigagg.aggregate_big_distributed(
                n, mesh, n_groups=512, run_size=run, collect=True,
                minmax=True))
        gid = bigagg.group_of_index_numpy(idx, 512)
        cnt = np.bincount(gid, minlength=512)
        sums = np.zeros(512, np.uint64)
        np.add.at(sums, gid, idx.astype(np.uint64))
        mn = np.full(512, 0xFFFFFFFF, np.uint32)
        mx = np.zeros(512, np.uint32)
        np.minimum.at(mn, gid, idx)
        np.maximum.at(mx, gid, idx)
        keep = cnt > 0
        dry["dbigagg"] = bool(
            res.all_ok and np.array_equal(tbl["key"], np.flatnonzero(keep))
            and np.array_equal(tbl["count"], cnt[keep])
            and np.array_equal(tbl["sum"], sums[keep])
            and np.array_equal(tbl["min"], mn[keep])
            and np.array_equal(tbl["max"], mx[keep]))
        res, _, _ = counted("dbigjoin (dry run)", passes_recorded,
                            lambda: dbigjoin.join_big_distributed(
                                n, n, mesh, run_size=run, buckets_per_dev=2))
        dry["dbigjoin"] = res.all_ok and res.matched == (n + 1) // 2
        (res, got), _, _ = counted(
            "dbigwindow (dry run)", passes_recorded,
            lambda: dbigwindow.window_big_distributed(
                n, mesh, partitions=16, run_size=run, buckets_per_dev=2,
                collect=True))
        okey, oord, oval = b_win.rows_numpy(idx, 16)
        perm = np.lexsort((idx, oord, okey))
        sk_, sv_ = okey[perm], oval[perm].astype(np.uint64)
        new = np.r_[True, sk_[1:] != sk_[:-1]]
        i_ = np.arange(n)
        ps = np.maximum.accumulate(np.where(new, i_, 0))
        cs = np.cumsum(sv_)
        dry["dbigwindow"] = bool(
            res.all_ok
            and np.array_equal(got["rn"], (i_ - ps + 1).astype(np.uint32))
            and np.array_equal(got["cum"], cs - np.r_[0, cs[:-1]][ps]))
        res, _, _ = counted("dbigquantile (dry run)", passes_recorded,
                            lambda: dbigquantile.quantile_big_distributed(
                                n, [(1, 1), 0.99], mesh, run_size=run))
        sq = np.sort(keygen_hash_numpy(idx))
        ((p99_num, p99_shift),) = canon_qs([0.99])
        dry["dbigquantile"] = bool(
            res.all_ok and res.values[0] == sq[(n + 1) // 2 - 1]
            and res.values[1] == sq[disc_rank(p99_num, p99_shift, n)])
        (res, (tk, tp)), _, _ = counted(
            "dbigtopk (dry run)", passes_recorded,
            lambda: dbigtopk.top_k_big_distributed(n, 64, mesh, run_size=run,
                                                   collect=True))
        okeys = keygen_hash_numpy(idx)
        order = np.argsort(okeys, kind="stable")[:64]
        dry["dbigtopk"] = bool(res.all_ok and np.array_equal(tk, okeys[order])
                               and np.array_equal(tp, order.astype(
                                   np.uint32)))
        res, _, _ = counted("dbigsetops intersect (dry run)", passes_recorded,
                            lambda: dbigsetops.set_op_big_distributed(
                                "intersect", n, n, mesh, g_a=96, g_b=160,
                                offset=32, run_size=run, collect=True,
                                capacity_factor=8.0))
        want = bigsetops.expected_result_numpy("intersect", n, 96, n, 160,
                                               32)
        dry["dbigsetops"] = bool(res.all_ok and all(
            np.array_equal(res.table[c], w)
            for c, w in zip(("key", "count_a", "count_b"), want)))
        res, _, _ = counted("dbigdistinct", passes_recorded,
                            lambda: dbigdistinct.count_distinct_big_distributed(
                                n, mesh, n_groups=64, n_values=100,
                                run_size=run, collect=True,
                                capacity_factor=8.0))
        k_, v_ = b_dist.rows_of_index_numpy(idx, 64, 100)
        pairs = np.unique((k_.astype(np.uint64) << np.uint64(32)) | v_)
        dry["dbigdistinct"] = bool(
            res.all_ok and np.array_equal(res.table["key"], np.arange(64))
            and np.array_equal(res.table["count_distinct"], np.bincount(
                (pairs >> np.uint64(32)).astype(np.int64), minlength=64))
            and np.array_equal(res.table["count"], np.bincount(
                k_, minlength=64)))
        (res, tbl), _, _ = counted(
            "dbigpipe", passes_recorded,
            lambda: dbigpipe.join_aggregate_big_distributed(
                n, n, mesh, n_groups=128, run_size=run, collect=True))
        rk_ = keygen_hash_numpy((idx * np.uint32(2654435761)) % np.uint32(n))
        lk_ = rk_ & ~np.uint64(1)
        hit = idx % 2 == 0
        jv = murmur_fmix32_numpy(
            (lk_ & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            ^ (lk_ >> np.uint64(32)).astype(np.uint32)
            ^ np.uint32(0xABCD1234)).astype(np.uint64)
        g_ = b_pipe.group_of_join_key_numpy(lk_, 128)
        cnt = np.bincount(g_[hit], minlength=128)
        sums = np.zeros(128, np.uint64)
        np.add.at(sums, g_[hit], jv[hit])
        keep = cnt > 0
        dry["dbigpipe"] = bool(
            res.all_ok and np.array_equal(tbl["key"], np.flatnonzero(keep))
            and np.array_equal(tbl["count"], cnt[keep])
            and np.array_equal(tbl["sum"], sums[keep]))
        (res, got), _, _ = counted(
            "dbigorderby", passes_recorded,
            lambda: dbigorderby.order_by_big_distributed(
                n, mesh, a_card=19, run_size=run, buckets_per_dev=2,
                collect=True))
        a_, b_, pay_ = b_ob.rows_numpy(idx, 19)
        perm = np.lexsort((idx, b_, ~a_))
        dry["dbigorderby"] = bool(
            res.all_ok and np.array_equal(got["a"], a_[perm])
            and np.array_equal(got["b"], b_[perm])
            and np.array_equal(got["idx"], perm.astype(np.uint32))
            and np.array_equal(got["pay"], pay_[perm]))
        if not all(dry.values()):
            fail(f"the dry run's out-of-core steps on LocalMesh(8) differ "
                 f"from numpy: {dry}")
        log(f"      the dry run's out-of-core steps at {n} rows (8 shards x "
            f"2 runs x {run}) and dbigdistinct, dbigpipe, dbigorderby on "
            f"LocalMesh(8): equal to numpy {dry}")

        # (b) the nine CLIs with --distributed --devices 8 at the JAX CLI's
        # defaults (runs of 2^26)
        for base in (["bench-bigagg"], ["bench-bigjoin"], ["bench-bigpipe"],
                     ["bench-bigtopk"], ["bench-bigtopk", "--largest"],
                     ["bench-bigdistinct"],
                     ["bench-bigsetops", "--op", "union"],
                     ["bench-bigsetops", "--op", "intersect"],
                     ["bench-bigsetops", "--op", "except"],
                     ["bench-bigquantile"], ["bench-bigquantile", "--cont"],
                     ["bench-bigwindow"], ["bench-bigorderby"]):
            argv = base + ["--distributed", "--devices", "8"]
            (row,), counts, planned = counted(" ".join(argv),
                                              passes_recorded,
                                              lambda: cli_rows(argv))
            log(f"      {json.dumps(row)}")
            if not (row["verified"] and all(row["checks"].values())
                    and row["composed"] and row["devices"] == 8):
                fail(f"{' '.join(argv)}: a check failed: {row}")
            dist_rows.append(row)
            log(f"      {' '.join(argv)}: every check holds, "
                f"{row['time_s']:.4f} s, {row['value'] / 1e9:.4f} G "
                f"{row['unit']}, peak {row['peak_mem_bytes'] / 1e9:.2f} GB, "
                f"{row['sort_passes']} sort passes, balance "
                f"{row.get('balance', 'n/a (no rows move)')}; launches "
                f"{counts} = recorded passes {planned}")
            torch.cuda.empty_cache()

        # (c) --devices 1 --force-composed at 2^28: the composed machinery
        # on a mesh of one
        for argv in (["bench-bigagg", "--n", str(1 << 28)],
                     ["bench-bigjoin", "--n-left", str(1 << 28),
                      "--n-right", str(1 << 28)]):
            argv = argv + ["--distributed", "--devices", "1",
                           "--force-composed"]
            (row,), counts, planned = counted(" ".join(argv),
                                              passes_recorded,
                                              lambda: cli_rows(argv))
            log(f"      {json.dumps(row)}")
            if not (row["verified"] and all(row["checks"].values())
                    and row["composed"] and row["devices"] == 1):
                fail(f"{' '.join(argv)}: a check failed: {row}")
            dist_rows.append(row)
            log(f"      {' '.join(argv)}: every check holds, "
                f"{row['time_s']:.4f} s, peak "
                f"{row['peak_mem_bytes'] / 1e9:.2f} GB; launches {counts} = "
                f"recorded passes {planned}")
            torch.cuda.empty_cache()

        # (d) a bench-bigagg and a bench-bigjoin --distributed --devices 8
        # process, each stopped partway, resumed through the CLI from
        # --checkpoint-dir, against an uninterrupted run
        stopper = (
            "import os, sys\n"
            "from tpu_qe_torch.__main__ import main\n"
            "from tpu_qe_torch.ops import bigagg, dbigjoin\n"
            "save, record = bigagg._run_ck_save, dbigjoin._DJoinState.record\n"
            "def stop_after_one_save(*a):\n"
            "    save(*a)\n"
            "    os._exit(3)\n"
            "def stop_after_one_record(self, b, vals):\n"
            "    record(self, b, vals)\n"
            "    os._exit(3)\n"
            "bigagg._run_ck_save = stop_after_one_save\n"
            "dbigjoin._DJoinState.record = stop_after_one_record\n"
            "main(sys.argv[1:])\n")
        n_a, run_a = 1 << 28, 1 << 24          # two runs a shard
        agg_argv = ["bench-bigagg", "--distributed", "--devices", "8",
                    "--n", str(n_a), "--run-size", str(run_a)]
        with tempfile.TemporaryDirectory() as part_dir:
            rc = subprocess.run([sys.executable, "-c", stopper] + agg_argv
                                + ["--checkpoint-dir", part_dir],
                                timeout=600).returncode
            tables = sorted(os.listdir(part_dir))
            if rc != 3 or tables != ["bigagg_rund0.npz"]:
                fail(f"the distributed GROUP BY stopped after one round "
                     f"exited with {rc} and left {tables}")
            (row,), counts, planned = counted(
                "resumed bench-bigagg --distributed", passes_recorded,
                lambda: cli_rows(agg_argv + ["--checkpoint-dir", part_dir]))
            _, got = dbigagg.aggregate_big_distributed(
                n_a, mesh, run_size=run_a, checkpoint_dir=part_dir,
                collect=True)
            _, want = dbigagg.aggregate_big_distributed(
                n_a, mesh, run_size=run_a, collect=True)
            if not (row["verified"] and all(np.array_equal(got[k], want[k])
                                            for k in want)):
                fail(f"the resumed distributed GROUP BY differs from a whole "
                     f"run: {row}")
        log(f"      bench-bigagg --distributed --devices 8 at 2^28 resumed "
            f"with one of two round tables: every check holds, the table "
            f"equals a whole run's; launches {counts} = recorded passes "
            f"{planned}")
        n_j, run_j = 1 << 27, 1 << 24
        join_argv = ["bench-bigjoin", "--distributed", "--devices", "8",
                     "--n-left", str(n_j), "--n-right", str(n_j),
                     "--run-size", str(run_j), "--buckets", "2"]
        meta = np.asarray([n_j, n_j, 8, run_j, 2, 7, 4096], np.int64)
        with tempfile.TemporaryDirectory() as full, \
                tempfile.TemporaryDirectory() as part_dir:
            whole = dbigjoin.join_big_distributed(
                n_j, n_j, mesh, run_size=run_j, buckets_per_dev=2,
                checkpoint_dir=full)
            rc = subprocess.run([sys.executable, "-c", stopper] + join_argv
                                + ["--checkpoint-dir", part_dir],
                                timeout=600).returncode
            stopped = dbigjoin._DJoinState.load(part_dir, meta)
            if rc != 3 or stopped is None or int(stopped.done.sum()) != 1:
                fail(f"the distributed join stopped after one bucket round "
                     f"exited with {rc} and did not leave one round recorded")
            (row,), counts, planned = counted(
                "resumed bench-bigjoin --distributed", passes_recorded,
                lambda: cli_rows(join_argv + ["--checkpoint-dir", part_dir]))
            a = dbigjoin._DJoinState.load(full, meta)
            b = dbigjoin._DJoinState.load(part_dir, meta)
            if not (row["verified"] and whole.all_ok and b.done.all()
                    and row["matched"] == whole.matched
                    and np.array_equal(a.scalars, b.scalars)
                    and np.array_equal(a.bounds, b.bounds)):
                fail(f"the resumed distributed join differs from the whole "
                     f"run: {row}")
        log(f"      bench-bigjoin --distributed --devices 8 at 2^27 x 2^27 "
            f"resumed after one of two bucket rounds: every shard's "
            f"per-bucket scalars identical to the whole run's; launches "
            f"{counts} = recorded passes {planned}")

        # (e) a GroupMesh over NCCL at world size 1: the composed GROUP BY
        # equals LocalMesh(1)'s
        import torch.distributed as tdist
        tdist.init_process_group("nccl", store=tdist.HashStore(), rank=0,
                                 world_size=1)
        try:
            gm = make_mesh()
            kw = dict(n_groups=1 << 16, run_size=1 << 22, collect=True,
                      minmax=True, force_composed=True)
            (gres, gtab), _, _ = counted(
                "aggregate_big_distributed on a GroupMesh", passes_recorded,
                lambda: dbigagg.aggregate_big_distributed(1 << 24, gm, **kw))
            lres, ltab = dbigagg.aggregate_big_distributed(
                1 << 24, LocalMesh(1, dev), **kw)
            if not (isinstance(gm, GroupMesh) and gres.all_ok
                    and gres.n_groups == lres.n_groups
                    and all(np.array_equal(gtab[k], ltab[k]) for k in ltab)):
                fail("aggregate_big_distributed on a GroupMesh over NCCL "
                     "differs from LocalMesh(1)")
        finally:
            tdist.destroy_process_group()
        log("      GroupMesh over NCCL, world size 1: "
            "aggregate_big_distributed(2^24, force_composed=True) equals "
            "LocalMesh(1)'s table")
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    for name in ("block_histogram", "exclusive_scan", "rank_and_scatter"):
        launches[name] += path_launches[name]
    log(f"[19/20] the distributed out-of-core operators: the dry run's steps "
        f"on LocalMesh(8) equal numpy; the nine CLIs with --distributed "
        f"--devices 8 at the JAX CLI's sizes ({len(dist_rows) - 2} runs) and "
        f"two --force-composed runs at 2^28, every check true; two resumes; "
        f"a GroupMesh over NCCL; no torch.sort / argsort / unique, B1-B3 "
        f"launched once per recorded pass "
        f"({path_launches['block_histogram']} times each); phase 19 "
        f"{time.perf_counter() - t0:.1f} s")

    # -- 20. the SQL executor's mesh= path: Database.sql / explain over a
    # LocalMesh of 8 shards on the card, torch.sort / argsort / unique made
    # to raise: bench.sql's query at 2^27 rows, every shape family of
    # tests/sql_dist_battery.py at 2^22 rows, a GroupMesh over NCCL
    t0 = time.perf_counter()
    for name in path_launches:
        path_launches[name] = 0
    torch.cuda.empty_cache()
    spec = importlib.util.spec_from_file_location(
        "sql_dist_battery", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "tests", "sql_dist_battery.py"))
    sdb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sdb)
    mesh = LocalMesh(8, dev)

    def same_rows(want, got, rtol=1e-5, ordered=False):
        try:
            sdb.compare(want, got, rtol=rtol, ordered=ordered)
        except AssertionError as e:
            return str(e)[:300]
        return None

    for mod, name, _ in saved:
        setattr(mod, name, refuse)
    try:
        # (a) bench.sql's query (tools/bench_sql.py) through mesh= at its
        # size, the table bench.sql keeps resident: bench.sql's run with
        # mesh=8 (an untimed warm-up, then the timed call, host clock fenced
        # by synchronize, with the seconds of _dist_table's read-back),
        # then the in-core Database.sql on the same columns
        n, groups = 1 << 27, 4096
        (row, got, (key, v)), counts, planned = counted(
            "bench.sql's query through mesh= at 2^27 rows", passes_recorded,
            lambda: bsql.run(n, groups, dev, mesh=8))
        db = Database(dev)
        db.register("t", Table({"k": key, "v": v}))
        bad = same_rows(db.sql(bsql.QUERY), got, ordered=True)
        if bad or not row["verified"]:
            fail(f"bench.sql's query through mesh= differs from the in-core "
                 f"answer or the hand-composed operators: {bad}, {row}")
        log(f"      {json.dumps(row)}")
        log(f"      bench.sql's query through mesh=LocalMesh(8) at 2^27 rows "
            f"-> {row['groups_out']} groups, bit-equal to the in-core answer: "
            f"{row['time_s']:.4f} s after a warm-up ({row['read_back_s']:.4f}"
            f" s, {100 * row['read_back_share']:.1f} % in _dist_table's "
            f"read-back), peak {row['peak_mem_bytes'] / 1e9:.2f} GB, "
            f"{row['sort_passes']} sort passes; launches over the bench "
            f"{counts} = recorded passes {planned} ({smi})")
        del db, key, v, got
        torch.cuda.empty_cache()

        # (b) every shape family at 2^22 rows (right side 2^20 unique keys)
        # and the tables of the reference's own-table tests, each against
        # the in-core answer on the card; explain names the distributed tier
        fam_s = time.perf_counter()
        fams = 0
        for name, f in sdb.FAMILIES.items():
            db = Database(dev)
            for nm, cols in sdb.tables(f.seed_for(8), n=1 << 22,
                                       m=1 << 20).items():
                db.register(nm, cols)
            want = db.sql(f.sql)
            got, counts, planned = counted(
                f"mesh= {name}", passes_recorded,
                lambda: db.sql(f.sql, mesh=mesh))
            bad = same_rows(want, got, f.rtol, f.ordered)
            if bad:
                fail(f"mesh= {name} at 2^22 rows differs from the in-core "
                     f"answer: {bad}")
            if not db.explain(f.sql, mesh=mesh).startswith(
                    "tier: distributed (8 devices)"):
                fail(f"explain(mesh=) of {name} names another tier")
            fams += 1
        for name, (make, sql, ordered, _) in sdb.OWN_TABLES.items():
            db = Database(dev)
            for nm, cols in make().items():
                db.register(nm, cols)
            want = db.sql(sql)
            got, counts, planned = counted(f"mesh= {name}", passes_recorded,
                                           lambda: db.sql(sql, mesh=mesh))
            bad = same_rows(want, got, ordered=ordered)
            if bad:
                fail(f"mesh= {name} differs from the in-core answer: {bad}")
            fams += 1
        tabs = sdb.tables(11, n=1 << 22, m=1 << 20)
        db = Database(dev)
        for nm, cols in tabs.items():
            db.register(nm, cols)
        empty = db.sql(sdb.FAMILIES["where_empty_result"].sql, mesh=mesh)
        if len(empty["k"]) or len(empty["c"]):
            fail("the zero-row GROUP BY through mesh= returned rows")
        del db
        torch.cuda.empty_cache()
        log(f"      {fams} query families of tests/sql_dist_battery.py "
            f"through mesh=LocalMesh(8) ({len(sdb.FAMILIES)} at 2^22 rows, "
            f"{len(sdb.OWN_TABLES)} on their own tables) equal the in-core "
            f"answers (integers bit for bit, floats at the family's rtol); "
            f"explain names the distributed tier; B1-B3 launched once per "
            f"recorded pass in each; {time.perf_counter() - fam_s:.1f} s")

        # (c) a GroupMesh over NCCL at world size 1: a GROUP BY equals
        # LocalMesh(1)'s answer
        import torch.distributed as tdist
        f = sdb.FAMILIES["group_by_three_columns"]
        db = Database(dev)
        for nm, cols in sdb.tables(f.seed, n=1 << 22, m=1 << 20).items():
            db.register(nm, cols)
        want = db.sql(f.sql, mesh=LocalMesh(1, dev))
        tdist.init_process_group("nccl", store=tdist.HashStore(), rank=0,
                                 world_size=1)
        try:
            gm = make_mesh()
            got, counts, planned = counted(
                "mesh= on a GroupMesh (NCCL)", passes_recorded,
                lambda: db.sql(f.sql, mesh=gm))
        finally:
            tdist.destroy_process_group()
        if not isinstance(gm, GroupMesh) or any(
                got[c].dtype != want[c].dtype
                or not np.array_equal(got[c], want[c]) for c in want):
            fail("Database.sql(mesh=GroupMesh over NCCL) differs from "
                 "LocalMesh(1)'s answer")
        del db
        log(f"      GroupMesh over NCCL, world size 1: a three-column GROUP "
            f"BY at 2^22 rows equals LocalMesh(1)'s answer; launches "
            f"{counts} = recorded passes {planned}")
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    for name in ("block_histogram", "exclusive_scan", "rank_and_scatter"):
        launches[name] += path_launches[name]
    log(f"[20/20] the SQL executor's mesh= path: bench.sql's query at 2^27 "
        f"rows and {fams} query families on LocalMesh(8) equal the in-core "
        f"answers; a GroupMesh over NCCL; no torch.sort / argsort / unique, "
        f"B1-B3 launched once per recorded pass "
        f"({path_launches['block_histogram']} times each); phase 20 "
        f"{time.perf_counter() - t0:.1f} s")

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
                         "bench-matrix + window, quantile at 2^22 + "
                         "bench-big + the out-of-core operators + "
                         "bigquantile, bigwindow, bigorderby + the SQL "
                         "tier + the out-of-core SQL tier + the exchange "
                         "layer (dsort, dops, dwindow, dorderby, "
                         "dquantile) + bench-big --distributed + the "
                         "distributed out-of-core operators (dbig*) + "
                         "the SQL executor's mesh= path"),
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
