"""The SQL tier's macro benchmark.

    python -m tpu_qe_torch.bench.sql [--n 2^27] [--groups 4096]
        [--device cuda] [--mesh D] [--trace-dir DIR]

The benchmark is the JAX package's tools/bench_sql.py: one analytics
query (filter + GROUP BY with COUNT / SUM / MIN / MAX, ORDER BY the group)
over a table generated on the device from the row index (hashing.py:
keygen_hash for the group, murmur_fmix32 for the value), run through
`Database.sql`, beside the same plan composed by hand from the operators
(ops/filter.compact, ops/aggregate.group_aggregate_multi) as the
front-end control. Each path runs once untimed (the kernels' build and
first launches), then once timed. One JSON line: rows/s of the SQL run
(`value`), `time_s`, `direct_ops_time_s`, `frontend_overhead_pct`, the
LSD passes of the timed SQL run (`sort_passes`, sort.driver.RADIX_PASSES),
its peak device memory and the card's name and power limit. With
--trace-dir one more SQL run is profiled (torch.profiler, DIR/trace.json)
and the line gains `profile`: kernel time by category and the idle share
(bench/big.profile). With --mesh D the SQL run goes through
`Database.sql(QUERY, mesh=LocalMesh(D, device))`, the distributed path,
and the line gains `mesh` and the seconds (and share) of the timed run
spent reading the registered columns back to the host (`read_back_s`,
`read_back_share`: Database._dist_table, fenced by a synchronize). Exit 1
when the two paths disagree.
On a CPU device the check holds the same and every time is "not
measured".
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

QUERY = ("SELECT k, COUNT(*) AS c, SUM(v) AS s, MIN(v) AS mn, "
         "MAX(v) AS mx FROM t WHERE v % 4 <> 0 GROUP BY k ORDER BY k")


def generate(n: int, groups: int, device):
    """The benchmark's table on `device`: the group key (u32, the low word
    of keygen_hash(idx, 7) masked to `groups`) and the value (i32, the low
    16 bits of murmur_fmix32(idx ^ 0xA5A5A5A5)), as tools/bench_sql.py
    makes them."""
    from tpu_qe_torch.hashing import keygen_hash, murmur_fmix32
    from tpu_qe_torch.table import from_plane
    idx = torch.arange(n, dtype=torch.int32, device=device)
    key = from_plane(keygen_hash(idx, 7).lo & (groups - 1), torch.uint32)
    v = murmur_fmix32(idx ^ (0xA5A5A5A5 - (1 << 32))) & 0xFFFF
    return key, v


def direct(key: torch.Tensor, v: torch.Tensor) -> dict:
    """QUERY's plan composed by hand from the operators: the filter mask,
    a stable compaction, one multi-aggregate over the u32 key (the SQL
    tier's U64 lift: the key's plane as lo, zero as hi) and g-row
    readbacks."""
    from tpu_qe_torch.bits import U64
    from tpu_qe_torch.ops.aggregate import group_aggregate_multi
    from tpu_qe_torch.ops.filter import compact
    from tpu_qe_torch.table import Table, column_to_numpy
    ct, cnt = compact(Table({"k": key, "v": v}), torch.fmod(v, 4) != 0)
    ct = ct.head(int(cnt))
    kp = ct["k"].view(torch.int32)
    res = group_aggregate_multi(U64(kp, torch.zeros_like(kp)),
                                {"v": ct["v"]},
                                {"v": ("count", "max", "min", "sum")})
    g = int(res.num_groups)
    a = res.aggs
    return {"k": res.key.lo[:g].cpu().numpy().view(np.uint32),
            "c": a["v_count"][:g].cpu().numpy(),
            "s": U64(a["v_sum"].lo[:g], a["v_sum"].hi[:g]).to_numpy().view(
                np.int64),
            "mn": column_to_numpy(a["v_min"][:g]),
            "mx": column_to_numpy(a["v_max"][:g])}


def _timed_database(device):
    """A Database whose mesh= read-back of the registered columns
    (_dist_table) adds its seconds to `read_back_s`."""
    from tpu_qe_torch.sql import Database

    class TimedDatabase(Database):
        read_back_s = 0.0

        def _dist_table(self, ref):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            out = super()._dist_table(ref)
            self.read_back_s += time.perf_counter() - t0
            return out
    return TimedDatabase(device)


def run(n: int, groups: int, device, trace_dir: str | None = None,
        mesh: int = 0):
    """Generate, run QUERY through SQL (over LocalMesh(mesh) when mesh)
    and the direct composition (one untimed run each first on the card),
    check that they agree; returns (JSON row, the SQL result, (key, v) on
    the device)."""
    from tpu_qe_torch.exchange import LocalMesh
    from tpu_qe_torch.sort import driver
    from tpu_qe_torch.table import Table
    if groups & (groups - 1) or not 1 <= groups <= 1 << 31:
        raise ValueError(f"--groups must be a power of two: {groups}")
    cuda = device.type == "cuda"
    key, v = generate(n, groups, device)
    db = _timed_database(device)
    db.register("t", Table({"k": key, "v": v}))
    on = LocalMesh(mesh, device) if mesh else None

    def passes():
        return sum(driver.RADIX_PASSES.values())

    def timed(fn):
        if cuda:
            fn()            # the kernels' build and first launches
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        db.read_back_s = 0.0
        before = passes()
        t0 = time.perf_counter()
        out = fn()          # host arrays: the readbacks synchronise
        return out, time.perf_counter() - t0, passes() - before

    got, t_sql, sql_passes = timed(lambda: db.sql(QUERY, mesh=on))
    read_back = db.read_back_s
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    want, t_direct, _ = timed(lambda: direct(key, v))
    ok = (list(got) == ["k", "c", "s", "mn", "mx"]
          and all(np.array_equal(got[c], want[c]) for c in want))
    row = {"metric": f"SQL filter+GROUP BY {n} rows -> {groups} groups"
                     + (f", mesh=LocalMesh({mesh})" if mesh else ""),
           "verified": ok, "unit": "rows/s", "groups_out": len(got["k"]),
           "sort_passes": sql_passes}
    if mesh:
        row["mesh"] = mesh
    if not cuda:
        row.update({"value": "not measured", "time_s": "not measured",
                    "direct_ops_time_s": "not measured",
                    "frontend_overhead_pct": "not measured",
                    "device": "cpu"})
        if mesh:
            row.update({"read_back_s": "not measured",
                        "read_back_share": "not measured"})
        return row, got, (key, v)
    from tpu_qe_torch.bench.sol import card
    info = card()
    row.update({
        "value": n / t_sql, "time_s": t_sql, "direct_ops_time_s": t_direct,
        "frontend_overhead_pct": 100 * (t_sql - t_direct) / t_direct,
        "peak_mem_bytes": peak,
        "device": info["name"], "power_limit": info["power_limit"]})
    if mesh:
        row.update({"read_back_s": read_back,
                    "read_back_share": read_back / t_sql})
    if trace_dir:
        from tpu_qe_torch.bench.big import profile
        row["profile"] = profile(trace_dir, lambda: db.sql(QUERY, mesh=on))
    return row, got, (key, v)


def main(argv=None) -> int:
    from tpu_qe_torch.config import resolve_device
    ap = argparse.ArgumentParser(prog="python -m tpu_qe_torch.bench.sql")
    ap.add_argument("--n", type=int, default=1 << 27)
    ap.add_argument("--groups", type=int, default=4096)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", type=int, default=0,
                    help="run the query over LocalMesh(D) (0: in core)")
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args(argv)
    row, _, _ = run(args.n, args.groups, resolve_device(args.device),
                    args.trace_dir, args.mesh)
    print(json.dumps(row), flush=True)
    return 0 if row["verified"] else 1


if __name__ == "__main__":
    sys.exit(main())
