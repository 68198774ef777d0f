"""bench-bigsql: the out-of-core SQL tier (sql/bigexec.py) over virtual
tables generated on the device, one JSON line per run.

    python -m tpu_qe_torch bench-bigsql [--verb V] [--n 2^30]
        [--run-size 2^26] [--groups 2^16] [--median] [--where]
        [--trace-dir DIR] [--device cuda]

V is one of groupby (the default), orderby, head, distinct,
countdistinct, join, window, setops, range and vvjoin: the JAX package's
verb battery (tpu_qe/__main__.py), each checked against its closed form at
full size. Tables (each column a function of the row index i):

    big      k = fmix32(i) & (G - 1), v = i          (hashed groups)
    bigdet   k = i & (G - 1), v = i, d = (i >> log2 G) & 15
    dim      in-core: dk = 0..G-1, w = 2 dk + 1, grp = dk & 15   (join)
    bigfact  fk = i & (ND - 1), v = i  (NF = min(n, 2^29) rows)  (vvjoin)
    bigdim   dk = i, w = 2 i + 1, grp = i & 15  (ND = min(NF / 4, 2^27))
    seta, setb  k = i & (G - 1), k = (i & (G/2 - 1)) + G/2  (n/2 rows)

groupby runs SELECT k, COUNT(*), SUM(v), MIN(v), MAX(v) [, MEDIAN(v)] FROM
big [WHERE v % 4 <> 3] GROUP BY k and checks the count and the exact u64
sum totals (n, n(n-1)/2; with --where their closed forms) and, without
--where, the global MIN 0, MAX n-1 and G groups.

The line has the reference's fields (rows/s, time, the SQL, `verified`;
for the aggregate verbs the phase split `phase_runs_s`, `phase_combine_s`,
`phase_pct_s`) plus the LSD passes of its sorts (`sort_passes`,
sort.driver.RADIX_PASSES), the peak device memory and the card's name and
power limit. `compile_s` is the kernels' build at first use (torch
compiles no query). On the card an untimed run of the same verb at 2^17
rows comes first (the build and the kernels' first launches), as the JAX
package compiles outside its timed region. With --trace-dir one more run
is profiled (torch.profiler, DIR/trace.json) and the line gains `profile`
(bench/big.py). On a CPU device the checks hold the same and every time
is "not measured". Exit 0 when the check holds, else 1.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from tpu_qe_torch.config import resolve_device

VERBS = ("groupby", "orderby", "head", "distinct", "countdistinct", "join",
         "window", "setops", "range", "vvjoin")
L = 128                     # LIMIT of the row-returning verbs
WARM_N, WARM_RUN, WARM_G = 1 << 17, 1 << 13, 16


def _u32(p: torch.Tensor) -> torch.Tensor:
    from tpu_qe_torch.table import from_plane
    return from_plane(p, torch.uint32)


def vv_sizes(n: int) -> tuple[int, int]:
    """(fact rows, dimension rows) of vvjoin: both sides' (key, index)
    planes stay resident, so the fact side is bounded at 2^29."""
    nf = min(n, 1 << 29)
    return nf, min(nf >> 2, 1 << 27)


def generators(n: int, groups: int) -> dict:
    """Every virtual table's generators: name -> {column: fn(idx)}, each
    fn taking the int32 plane of the u32 row indices."""
    from tpu_qe_torch.hashing import murmur_fmix32
    G = groups
    shift = G.bit_length() - 1
    # the arithmetic shift of the int32 plane only sign-fills bits above
    # 31 - shift, never d's four
    assert shift <= 28, G
    _, nd = vv_sizes(n)
    return {
        "big": {"k": lambda i: _u32(murmur_fmix32(i) & (G - 1)),
                "v": _u32},
        "bigdet": {"k": lambda i: _u32(i & (G - 1)), "v": _u32,
                   "d": lambda i: _u32((i >> shift) & 15)},
        # dimension indices stay below 2^27: 2 i + 1 does not wrap
        "bigfact": {"fk": lambda i: _u32(i & (nd - 1)), "v": _u32},
        "bigdim": {"dk": _u32, "w": lambda i: _u32(2 * i + 1),
                   "grp": lambda i: _u32(i & 15)},
        "seta": {"k": lambda i: _u32(i & (G - 1))},
        "setb": {"k": lambda i: _u32((i & (G // 2 - 1)) + G // 2)},
    }


def _verb(verb: str, n: int, G: int, median: bool, where: bool, dev):
    """(Database, SQL, check(out) -> bool, rows processed, max_groups,
    metric) of one verb at n rows and G groups."""
    from tpu_qe_torch.hashing import murmur_fmix32_numpy
    from tpu_qe_torch.sql import Database
    assert G & (G - 1) == 0 and n % G == 0 and n % 2 == 0, (n, G)
    gens = generators(n, G)
    per_g = n // G
    db = Database(dev)
    db.register_virtual("big", n, gens["big"])
    db.register_virtual("bigdet", n, gens["bigdet"])
    rows, mg = n, G
    metric = f"out-of-core SQL {verb} {n} rows, 1 card"

    if verb == "groupby":
        sel = "k, COUNT(*) AS c, SUM(v) AS s, MIN(v) AS mn, MAX(v) AS mx"
        if median:
            sel += ", MEDIAN(v) AS md"
        sql = (f"SELECT {sel} FROM big"
               + (" WHERE v % 4 <> 3" if where else "") + " GROUP BY k")

        def check(out):
            c_total = int(out["c"].astype(np.int64).sum())
            s_total = int(out["s"].astype(np.uint64).sum())
            if where:
                # the rows i % 4 == 3 leave (exact python ints)
                m = len(range(3, n, 4))
                exp_s = (n * (n - 1)) // 2 - (m * 3 + 4 * (m * (m - 1) // 2))
                return c_total == n - m and s_total == exp_s % (1 << 64)
            ok = (c_total == n and s_total == (n * (n - 1)) // 2
                  and int(out["mn"].min()) == 0
                  and int(out["mx"].max()) == n - 1
                  and len(out["k"]) == G)
            return ok and (not median or len(out["md"]) == G)
        metric = (f"out-of-core SQL GROUP BY {n} rows -> {G} groups, 1 card"
                  + (" (+MEDIAN)" if median else "")
                  + (" (+WHERE)" if where else ""))
    elif verb == "orderby":
        sql = f"SELECT v FROM big ORDER BY v DESC LIMIT {L}"

        def check(out):
            return np.array_equal(out["v"].astype(np.int64),
                                  np.arange(n - 1, n - 1 - L, -1))
    elif verb == "head":
        # the qualifying rows live in the last run: a full scan
        sql = f"SELECT k, v FROM big WHERE v >= {n - L} LIMIT {L}"

        def check(out):
            v = np.arange(n - L, n, dtype=np.uint32)
            k = murmur_fmix32_numpy(v) & np.uint32(G - 1)
            return (np.array_equal(out["v"], v)
                    and np.array_equal(out["k"], k))
    elif verb == "distinct":
        sql = "SELECT DISTINCT k FROM big"

        def check(out):
            return np.array_equal(np.sort(out["k"]),
                                  np.arange(G, dtype=np.uint32))
    elif verb == "countdistinct":
        sql = "SELECT k, COUNT(DISTINCT d) AS cd FROM bigdet GROUP BY k"
        # every run sees all G groups x 16 d values: G * 16 pairs per run
        mg = G * 16

        def check(out):
            return (len(out["k"]) == G
                    and np.array_equal(np.sort(out["k"]),
                                       np.arange(G, dtype=np.uint32))
                    and bool((out["cd"] == min(16, per_g)).all()))
    elif verb == "join":
        dk = np.arange(G, dtype=np.uint32)
        db.register("dim", {"dk": dk, "w": (2 * dk + 1).astype(np.uint32),
                            "grp": (dk & 15).astype(np.uint32)})
        sql = ("SELECT grp, COUNT(*) AS c, SUM(w) AS s FROM bigdet "
               "JOIN dim ON k = dk GROUP BY grp ORDER BY grp")

        def check(out):
            w = 2 * dk.astype(np.int64) + 1
            exp_s = np.array([per_g * int(w[(dk & 15) == t].sum())
                              for t in range(16)], np.int64)
            return (np.array_equal(out["grp"],
                                   np.arange(16, dtype=np.uint32))
                    and bool((out["c"].astype(np.int64) == n // 16).all())
                    and np.array_equal(out["s"].astype(np.int64), exp_s))
    elif verb == "window":
        sql = ("SELECT k, v, "
               "SUM(v) OVER (PARTITION BY k ORDER BY v) AS rs, "
               "ROW_NUMBER() OVER (PARTITION BY k ORDER BY v) AS rn, "
               "COUNT(v) OVER (PARTITION BY k) AS pc "
               f"FROM bigdet LIMIT {L}")
        rows = 2 * n        # prefix selection + whole-partition pass

        def check(out):
            j = np.arange(L, dtype=np.int64)
            return (bool((out["k"] == 0).all())
                    and np.array_equal(out["v"].astype(np.int64), j * G)
                    and np.array_equal(out["rs"].astype(np.int64),
                                       G * j * (j + 1) // 2)
                    and np.array_equal(out["rn"].astype(np.int64), j + 1)
                    and bool((out["pc"].astype(np.int64) == per_g).all()))
    elif verb == "range":
        # tie-aware RANGE over heavy order ties: d cycles 0..15 within each
        # partition, so every (k, d) run holds per_g / 16 rows and the
        # first L output rows (partition 0, run d = 0, j = 16 jj) share
        # one closed-form run total 8 G m (m - 1)
        sql = ("SELECT k, v, "
               "SUM(v) OVER (PARTITION BY k ORDER BY d RANGE BETWEEN "
               "UNBOUNDED PRECEDING AND CURRENT ROW) AS rs, "
               "ROW_NUMBER() OVER (PARTITION BY k ORDER BY d) AS rn, "
               "COUNT(*) OVER (PARTITION BY k ORDER BY d ROWS "
               f"BETWEEN 2 PRECEDING AND CURRENT ROW) AS fc "
               f"FROM bigdet LIMIT {L}")
        rows = 2 * n        # prefix selection + per-run side channel
        mg = 16 * G         # distinct (partition, order) runs
        m_run = per_g // 16
        assert m_run >= L and per_g % 16 == 0, (per_g, L)

        def check(out):
            jj = np.arange(L, dtype=np.int64)
            exp_rs = 8 * G * m_run * (m_run - 1)
            return (bool((out["k"] == 0).all())
                    and np.array_equal(out["v"].astype(np.int64),
                                       16 * G * jj)
                    and bool((out["rs"].astype(np.int64) == exp_rs).all())
                    and np.array_equal(out["rn"].astype(np.int64), jj + 1)
                    and np.array_equal(out["fc"].astype(np.int64),
                                       np.minimum(jj + 1, 3)))
    elif verb == "vvjoin":
        # fk = i mod ND matches every unique dim key exactly NF/ND times,
        # so with grp = dk & 15 the per-group closed forms are exact:
        # c_g = NF/16, s_g = (NF/ND) * sum_t (2 (g + 16 t) + 1)
        nf, nd = vv_sizes(n)
        assert nd % 16 == 0 and nf % nd == 0, (nf, nd)
        db.register_virtual("bigfact", nf, gens["bigfact"])
        db.register_virtual("bigdim", nd, gens["bigdim"])
        sql = ("SELECT grp, COUNT(*) AS c, SUM(w) AS s FROM bigfact "
               "JOIN bigdim ON fk = dk GROUP BY grp ORDER BY grp")
        rows = nf + nd
        mg = 16
        t_dim = nd // 16
        metric = f"out-of-core SQL vvjoin {nf} x {nd} rows, 1 card"

        def check(out):
            g = np.arange(16, dtype=np.int64)
            exp_s = [(nf // nd) * (t_dim * (2 * int(gg) + 1)
                                   + 16 * t_dim * (t_dim - 1)) for gg in g]
            return (np.array_equal(out["grp"].astype(np.int64), g)
                    and bool((out["c"].astype(np.int64) == nf // 16).all())
                    and [int(x) for x in out["s"]] == exp_s)
    elif verb == "setops":
        db.register_virtual("seta", n // 2, gens["seta"])
        db.register_virtual("setb", n // 2, gens["setb"])
        sql = "SELECT k FROM seta INTERSECT SELECT k FROM setb"

        def check(out):
            return np.array_equal(np.sort(out["k"]),
                                  np.arange(G // 2, G, dtype=np.uint32))
    else:
        raise SystemExit(f"unknown --verb {verb!r}")
    return db, sql, check, rows, mg, metric


def run(args) -> dict:
    from tpu_qe_torch.sort import driver
    from tpu_qe_torch.sort.bigsort import _build_seconds
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    compile_s = _build_seconds(dev)
    if cuda:
        # an untimed run of the same verb at a small size: the timed run
        # pays neither the kernels' build nor any kernel's first launch
        db, sql, check, _, mg, _ = _verb(args.verb, WARM_N, WARM_G,
                                         args.median, args.where, dev)
        assert check(db.sql(sql, run_size=WARM_RUN, max_groups=mg))
        del db
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    db, sql, check, rows, mg, metric = _verb(args.verb, args.n, args.groups,
                                             args.median, args.where, dev)
    stats: dict = {}
    before = sum(driver.RADIX_PASSES.values())
    if cuda:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = db.sql(sql, run_size=args.run_size, max_groups=mg, stats=stats)
    wall = time.perf_counter() - t0
    row = {"metric": metric, "value": rows / wall, "unit": "rows/s",
           "time_s": wall}
    for key in ("runs_s", "combine_s", "pct_s"):
        if key in stats:
            row[f"phase_{key}"] = stats[key]
    row.update({"sql": sql, "verified": bool(check(out)),
                "sort_passes": sum(driver.RADIX_PASSES.values()) - before})
    if not cuda:
        for k in row:
            if k in ("time_s", "value") or k.startswith("phase_"):
                row[k] = "not measured"
        row["device"] = "cpu"
        return row
    from tpu_qe_torch.bench.sol import card
    info = card()
    row.update({"compile_s": compile_s + stats.get("compile_s", 0.0),
                "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
                "device": info["name"], "power_limit": info["power_limit"]})
    if args.trace_dir:
        from tpu_qe_torch.bench.big import profile
        row["profile"] = profile(
            args.trace_dir, wall,
            lambda: db.sql(sql, run_size=args.run_size, max_groups=mg))
    return row


def main(args) -> int:
    row = run(args)
    print(json.dumps(row), flush=True)
    return 0 if row["verified"] else 1
