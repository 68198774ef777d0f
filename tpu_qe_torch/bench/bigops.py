"""The out-of-core operators' CLIs, one JSON line each:

    python -m tpu_qe_torch bench-bigagg [--n 2^30] [--groups 2^20]
        [--run-size 2^26] [--minmax] [--value-cols V] [--checkpoint-dir D]
    python -m tpu_qe_torch bench-bigjoin [--n-left 2^29] [--n-right 2^29]
        [--buckets B] [--outer [left|full]] [--checkpoint-dir D]
    python -m tpu_qe_torch bench-bigpipe [--n-left 2^29] [--n-right 2^29]
        [--groups 2^16] [--buckets B]
    python -m tpu_qe_torch bench-bigtopk [--n 2^30] [--k 1024] [--largest]
    python -m tpu_qe_torch bench-bigdistinct [--n 2^30] [--groups 2^16]
        [--values 2^8]
    python -m tpu_qe_torch bench-bigsetops [--op union|intersect|except]
        [--n-a 2^29] [--n-b 2^29] [--g-a 2^20] [--g-b 2^20] [--offset 2^19]
    python -m tpu_qe_torch bench-bigquantile [--n 2^30]
        [--qs 0.01,0.25,0.5,0.9,0.99] [--cont] [--run-size 2^26]
    python -m tpu_qe_torch bench-bigwindow [--n 2^29] [--partitions P]
        [--run-size 2^26] [--buckets B] [--checkpoint-dir D]
    python -m tpu_qe_torch bench-bigorderby [--n 2^30] [--a-card A]
        [--run-size 2^26] [--buckets B]

each with [--distributed [--devices D] [--force-composed]]
[--verbose-big] [--trace-dir DIR] [--device cuda]. The defaults
and the fields are the JAX package's CLI's (tpu_qe/__main__.py); the line
adds the passes its sorts ran (`sort_passes`, sort.driver.RADIX_PASSES),
the peak device memory and the card's name and power limit, and for
bench-bigagg, -bigjoin, -bigpipe and -bigwindow `sol_fraction` against
the port's envelope (bench/sol.py). On the card an untimed run of the
same path at a small size comes first (the kernels' build and first
launches), as the JAX package compiles outside its timed region. With --trace-dir one more run
is profiled (torch.profiler, DIR/trace.json) and the line gains `profile`
(bench/big.py). On a CPU device the checks hold the same and every time
is "not measured". Exit 0 when every check holds, else 1.

--distributed runs the distributed operator (ops/dbig*.py) over
make_mesh(--devices) on the device: one shard per card by default, a
LocalMesh of D shards on the device with --devices D (one card then does
every shard's work, its all_to_all a copy in the card's memory). At D = 1
the call delegates to the single-device operator unless --force-composed
(bench-bigquantile always runs composed, as the reference does);
--run-size is then per run of a shard and --buckets per shard. The line
adds `devices`, the mesh, `composed` (false where D = 1 delegated) and
`balance` where rows move (the most rows or
route pairs a shard received over their mean); the warm-up run is the
same path on the same mesh. bench-bigjoin --outer ignores --distributed,
as the reference does; bench-bigagg --distributed takes no --value-cols
and bench-bigwindow --distributed no --checkpoint-dir (the reference
asserts both).
"""

from __future__ import annotations

import json
import os

import torch

from tpu_qe_torch.config import resolve_device

WARM_N = 1 << 16            # rows of the untimed warm-up run
WARM_RUN = 1 << 14


def _bigagg(args, dev, warm: bool, **kw):
    from tpu_qe_torch.ops.bigagg import aggregate_big, aggregate_big_multi
    n, run, g = ((WARM_N, WARM_RUN, min(args.groups, 1 << 12)) if warm
                 else (args.n, args.run_size, args.groups))
    if args.value_cols > 1:
        return aggregate_big_multi(n, n_groups=g, run_size=run,
                                   value_cols=args.value_cols, device=dev,
                                   **kw)
    return aggregate_big(n, n_groups=g, run_size=run, minmax=args.minmax,
                         device=dev, **kw)


def _bigjoin(args, dev, warm: bool, **kw):
    n_l, n_r, b = ((WARM_N, WARM_N, 2) if warm
                   else (args.n_left, args.n_right, args.buckets))
    if args.outer is not None:
        from tpu_qe_torch.ops.bigouter import join_big_outer
        return join_big_outer(n_l, n_r, how=args.outer, n_buckets=b,
                              device=dev, **kw)
    from tpu_qe_torch.ops.bigjoin import join_big
    return join_big(n_l, n_r, n_buckets=b, device=dev, **kw)


def _bigpipe(args, dev, warm: bool, **kw):
    from tpu_qe_torch.ops.bigpipe import join_aggregate_big
    n_l, n_r, g, b = ((WARM_N, WARM_N, min(args.groups, 1 << 10), 2)
                      if warm else (args.n_left, args.n_right, args.groups,
                                    args.buckets))
    return join_aggregate_big(n_l, n_r, n_groups=g, n_buckets=b,
                              device=dev, **kw)


def _bigtopk(args, dev, warm: bool, **kw):
    from tpu_qe_torch.ops.bigtopk import top_k_big
    n, k, run = ((WARM_N, min(args.k, WARM_RUN), WARM_RUN) if warm
                 else (args.n, args.k, args.run_size))
    return top_k_big(n, k, run_size=run, largest=args.largest, device=dev,
                     **kw)


def _bigdistinct(args, dev, warm: bool, **kw):
    from tpu_qe_torch.ops.bigdistinct import count_distinct_big
    n, run, g = ((WARM_N, WARM_RUN, min(args.groups, 1 << 8)) if warm
                 else (args.n, args.run_size, args.groups))
    return count_distinct_big(n, n_groups=g, n_values=args.values,
                              run_size=run, device=dev, **kw)


def _bigsetops(args, dev, warm: bool, **kw):
    from tpu_qe_torch.ops.bigsetops import set_op_big
    if warm:
        sizes = dict(n_a=WARM_N, n_b=WARM_N, g_a=min(args.g_a, 1 << 10),
                     g_b=min(args.g_b, 1 << 10),
                     offset=min(args.offset, 1 << 9), run_size=WARM_RUN)
    else:
        sizes = dict(n_a=args.n_a, n_b=args.n_b, g_a=args.g_a, g_b=args.g_b,
                     offset=args.offset, run_size=args.run_size)
    return set_op_big(args.op, device=dev, **sizes, **kw)


def _bigquantile(args, dev, warm: bool, **kw):
    from tpu_qe_torch.ops.bigquantile import quantile_big, quantile_cont_big
    n, run = (WARM_N, WARM_RUN) if warm else (args.n, args.run_size)
    qs = [float(q) for q in args.qs.split(",")]
    fn = quantile_cont_big if args.cont else quantile_big
    return fn(n, qs, run_size=run, device=dev, **kw)


def _bigwindow(args, dev, warm: bool, **kw):
    from tpu_qe_torch.ops.bigwindow import window_big
    n, run, p, b = ((WARM_N, WARM_RUN, None, 2) if warm
                    else (args.n, args.run_size, args.partitions,
                          args.buckets))
    return window_big(n, partitions=p, run_size=run, n_buckets=b,
                      device=dev, **kw)


def _bigorderby(args, dev, warm: bool, **kw):
    from tpu_qe_torch.ops.bigorderby import order_by_big
    n, run, a, b = ((WARM_N, WARM_RUN, None, 2) if warm
                    else (args.n, args.run_size, args.a_card, args.buckets))
    return order_by_big(n, a_card=a, run_size=run, n_buckets=b, device=dev,
                        **kw)


def _warm(mesh) -> int:
    """Rows of the distributed warm-up run: two runs a shard."""
    return mesh.n_dev * 2 * WARM_RUN


def _dbigagg(args, mesh, warm: bool, **kw):
    from tpu_qe_torch.ops.dbigagg import aggregate_big_distributed
    kw.pop("stats", None)
    n, run, g = ((_warm(mesh), WARM_RUN, min(args.groups, 1 << 12)) if warm
                 else (args.n, args.run_size, args.groups))
    return aggregate_big_distributed(n, mesh, n_groups=g, run_size=run,
                                     minmax=args.minmax,
                                     force_composed=args.force_composed,
                                     **kw)


def _dbigjoin(args, mesh, warm: bool, **kw):
    from tpu_qe_torch.ops.dbigjoin import join_big_distributed
    n_l, n_r, run, b = ((_warm(mesh), _warm(mesh), WARM_RUN, 2) if warm
                        else (args.n_left, args.n_right, args.run_size,
                              args.buckets))
    return join_big_distributed(n_l, n_r, mesh, run_size=run,
                                buckets_per_dev=b,
                                force_composed=args.force_composed, **kw)


def _dbigpipe(args, mesh, warm: bool, **kw):
    from tpu_qe_torch.ops.dbigpipe import join_aggregate_big_distributed
    n_l, n_r, run, g, b = (
        (_warm(mesh), _warm(mesh), WARM_RUN, min(args.groups, 1 << 10), 2)
        if warm else (args.n_left, args.n_right, args.run_size, args.groups,
                      args.buckets))
    return join_aggregate_big_distributed(
        n_l, n_r, mesh, n_groups=g, run_size=run, buckets_per_dev=b,
        force_composed=args.force_composed, **kw)


def _dbigtopk(args, mesh, warm: bool, **kw):
    from tpu_qe_torch.ops.dbigtopk import top_k_big_distributed
    kw.pop("stats", None)
    n, k, run = ((_warm(mesh), min(args.k, WARM_RUN), WARM_RUN) if warm
                 else (args.n, args.k, args.run_size))
    return top_k_big_distributed(n, k, mesh, run_size=run,
                                 largest=args.largest,
                                 force_composed=args.force_composed, **kw)


def _dbigdistinct(args, mesh, warm: bool, **kw):
    from tpu_qe_torch.ops.dbigdistinct import count_distinct_big_distributed
    n, run, g = ((_warm(mesh), WARM_RUN, min(args.groups, 1 << 8)) if warm
                 else (args.n, args.run_size, args.groups))
    return count_distinct_big_distributed(
        n, mesh, n_groups=g, n_values=args.values, run_size=run,
        force_composed=args.force_composed, **kw)


def _dbigsetops(args, mesh, warm: bool, **kw):
    from tpu_qe_torch.ops.dbigsetops import set_op_big_distributed
    if warm:
        sizes = dict(n_a=_warm(mesh), n_b=_warm(mesh),
                     g_a=min(args.g_a, 1 << 10), g_b=min(args.g_b, 1 << 10),
                     offset=min(args.offset, 1 << 9), run_size=WARM_RUN)
    else:
        sizes = dict(n_a=args.n_a, n_b=args.n_b, g_a=args.g_a, g_b=args.g_b,
                     offset=args.offset, run_size=args.run_size)
    return set_op_big_distributed(args.op, mesh=mesh,
                                  force_composed=args.force_composed,
                                  **sizes, **kw)


def _dbigquantile(args, mesh, warm: bool, **kw):
    from tpu_qe_torch.ops.dbigquantile import (quantile_big_distributed,
                                               quantile_cont_big_distributed)
    kw.pop("stats", None)
    n, run = (_warm(mesh), WARM_RUN) if warm else (args.n, args.run_size)
    qs = [float(q) for q in args.qs.split(",")]
    fn = quantile_cont_big_distributed if args.cont \
        else quantile_big_distributed
    return fn(n, qs, mesh, run_size=run, **kw)


def _dbigwindow(args, mesh, warm: bool, **kw):
    from tpu_qe_torch.ops.dbigwindow import window_big_distributed
    n, run, p, b = ((_warm(mesh), WARM_RUN, None, 2) if warm
                    else (args.n, args.run_size, args.partitions,
                          args.buckets))
    return window_big_distributed(n, mesh, partitions=p, run_size=run,
                                  buckets_per_dev=b,
                                  force_composed=args.force_composed, **kw)


def _dbigorderby(args, mesh, warm: bool, **kw):
    from tpu_qe_torch.ops.dbigorderby import order_by_big_distributed
    n, run, a, b = ((_warm(mesh), WARM_RUN, None, 2) if warm
                    else (args.n, args.run_size, args.a_card, args.buckets))
    return order_by_big_distributed(n, mesh, a_card=a, run_size=run,
                                    buckets_per_dev=b,
                                    force_composed=args.force_composed,
                                    **kw)


def _row_bigagg(args, res, where: str) -> dict:
    if args.value_cols > 1:
        where += f", {args.value_cols} value cols"
    return {
        "metric": f"out-of-core GROUP BY {res.n} rows -> "
                  f"{res.n_groups} groups, {where}",
        "unit": "rows/s", "value": res.rows_per_s, "time_s": res.seconds,
        "phase_partial_s": res.phase_a_s, "phase_combine_s": res.phase_b_s,
        "verified": res.all_ok,
        "checks": {"count": res.count_ok, "sum": res.sum_ok,
                   "keys": res.keys_ok, "groups": res.groups_ok,
                   "minmax": res.minmax_ok}}


def _row_bigjoin(args, res, where: str) -> dict:
    row = {"unit": "left rows/s", "value": res.rows_per_s,
           "time_s": res.seconds, "matched": res.matched,
           "phase_sort_s": res.phase_a_s,
           "phase_plan_s": res.seconds - res.phase_a_s - res.phase_c_s,
           "phase_join_s": res.phase_c_s, "verified": res.all_ok,
           "checks": {"match_flags": res.match_ok, "values": res.val_ok,
                      "counts": res.count_ok}}
    if args.outer is not None:
        row["metric"] = (f"out-of-core {args.outer.upper()} OUTER join "
                         f"{res.n_l} x {res.n_r} rows, {where}")
        row["right_only"] = res.right_only
        row["checks"]["right_only"] = res.ro_ok
    else:
        row["metric"] = (f"out-of-core FK join {res.n_l} x {res.n_r} rows, "
                         f"{where}")
    if hasattr(res, "phase_x_s"):       # the distributed join's phases
        row["phase_plan_s"] = res.phase_b_s
        row["phase_exchange_s"] = res.phase_x_s
    return row


def _row_bigpipe(args, res, where: str) -> dict:
    return {
        "metric": f"fused out-of-core join+GROUP BY {res.n_l} x {res.n_r} "
                  f"rows -> {res.n_groups} groups, {where}",
        "unit": "left rows/s", "value": res.rows_per_s,
        "time_s": res.seconds, "matched": res.matched,
        "verified": res.all_ok,
        "checks": {"join": res.join_ok, "count": res.count_ok,
                   "keys": res.keys_ok}}


def _row_bigtopk(args, res, where: str) -> dict:
    return {
        "metric": f"out-of-core top-{res.k} of {res.n} rows, {where}",
        "unit": "rows/s", "value": res.rows_per_s, "time_s": res.seconds,
        "phase_select_s": res.phase_a_s, "phase_combine_s": res.phase_b_s,
        "verified": res.all_ok,
        "checks": {"hash": res.hash_ok, "order": res.order_ok,
                   "distinct": res.distinct_ok}}


def _row_bigdistinct(args, res, where: str) -> dict:
    return {
        "metric": f"out-of-core COUNT(DISTINCT) {res.n} rows -> "
                  f"{res.num_groups} groups, {where}",
        "unit": "rows/s", "value": res.rows_per_s, "time_s": res.seconds,
        "phase_dedup_s": res.dedup_s, "phase_combine_s": res.combine_s,
        **({"phase_route_s": res.route_s} if hasattr(res, "route_s")
           else {}),
        "runs": res.n_runs, "verified": res.all_ok,
        "checks": {"groups": res.groups_ok and res.num_groups == min(
                       res.n_groups, res.n),
                   "count_distinct": res.cd_ok, "count": res.cnt_ok,
                   "keys": res.keys_ok, "no_overflow": not res.overflow}}


def _row_bigsetops(args, res, where: str) -> dict:
    return {
        "metric": f"out-of-core {res.op.upper()} {res.n_a}+{res.n_b} rows "
                  f"-> {res.num} keys, {where}",
        "unit": "rows/s", "value": res.rows_per_s, "time_s": res.seconds,
        "phase_dedup_s": res.dedup_s,
        **({"phase_local_s": res.combine_s, "phase_route_s": res.route_s}
           if hasattr(res, "route_s") else
           {"phase_combine_s": res.combine_s}),
        "verified": res.all_ok,
        "checks": {"counts": res.counts_ok, "keys": res.keys_ok,
                   "no_overflow": not res.overflow,
                   "num": res.num == res.expected_num}}


def _row_bigquantile(args, res, where: str) -> dict:
    kind = "PERCENTILE_CONT" if args.cont else "quantiles"
    row = {
        "metric": f"out-of-core exact {kind} ({len(args.qs.split(','))} q) "
                  f"over {res.n} rows, {where}",
        "value": res.rows_per_s, "unit": "rows/s", "time_s": res.seconds,
        "runs": res.n_runs, "cert_ok": res.all_ok, "verified": res.all_ok,
        "checks": {"cert": res.cert_ok}}
    if not args.cont:
        row["phase_runs_s"] = res.runs_s
        row["phase_select_s"] = res.select_s
    return row


def _row_bigwindow(args, res, where: str) -> dict:
    return {
        "metric": f"out-of-core window rn+rank+sum+lag, {res.n} rows x "
                  f"{res.partitions} partitions, {where}",
        "value": res.rows_per_s, "unit": "rows/s", "time_s": res.seconds,
        "phase_runs_s": res.phase_a_s, "phase_buckets_s": res.phase_c_s,
        "verified": res.all_ok,
        "checks": {"sorted": res.sorted_ok, "hash": res.hash_ok,
                   "window": res.window_ok, "count": res.count_ok,
                   "boundary": res.boundary_ok}}


def _row_bigorderby(args, res, where: str) -> dict:
    return {
        "metric": f"out-of-core ORDER BY a DESC, b ASC, {res.n} rows, "
                  f"{where}",
        "value": res.rows_per_s, "unit": "rows/s", "time_s": res.seconds,
        "phase_runs_s": res.phase_a_s, "phase_buckets_s": res.phase_c_s,
        "verified": res.all_ok,
        "checks": {"sorted": res.sorted_ok, "hash": res.hash_ok,
                   "boundary": res.boundary_ok, "count": res.count_ok,
                   "perm": res.perm_ok}}


def _sol(cmd, args, res) -> float | None:
    from tpu_qe_torch.bench import sol
    if cmd == "bigagg":
        return sol.bigagg_sol_seconds(res.n, args.run_size, args.groups,
                                      args.value_cols, args.minmax)
    if cmd == "bigwindow":
        return sol.bigwindow_sol_seconds(
            res.n, args.run_size,
            args.buckets or max(2, -(-res.n // (1 << 26))))
    if cmd not in ("bigjoin", "bigpipe"):
        return None
    buckets = args.buckets or max(2, -(-(res.n_l + res.n_r) // (1 << 26)))
    if cmd == "bigjoin" and args.outer is None:
        return sol.bigjoin_sol_seconds(res.n_l, res.n_r, buckets)
    if cmd == "bigpipe":
        return sol.bigpipe_sol_seconds(res.n_l, res.n_r, buckets,
                                       args.groups)
    return None     # the OUTER join has no envelope yet


COMMANDS = {
    "bigagg": (_bigagg, _dbigagg, _row_bigagg),
    "bigjoin": (_bigjoin, _dbigjoin, _row_bigjoin),
    "bigpipe": (_bigpipe, _dbigpipe, _row_bigpipe),
    "bigtopk": (_bigtopk, _dbigtopk, _row_bigtopk),
    "bigdistinct": (_bigdistinct, _dbigdistinct, _row_bigdistinct),
    "bigsetops": (_bigsetops, _dbigsetops, _row_bigsetops),
    "bigquantile": (_bigquantile, _dbigquantile, _row_bigquantile),
    "bigwindow": (_bigwindow, _dbigwindow, _row_bigwindow),
    "bigorderby": (_bigorderby, _dbigorderby, _row_bigorderby),
}
# where the distributed stats name the rows that moved (balance)
_MOVED = ("shard_rows", "shard_pairs")


def run(cmd: str, args) -> dict:
    from tpu_qe_torch.sort import driver
    from tpu_qe_torch.sort.bigsort import _build_seconds
    single, dist, make_row = COMMANDS[cmd]
    if cmd == "bigagg":
        assert args.value_cols >= 1, "--value-cols must be >= 1"
        assert args.value_cols == 1 or not (
            args.minmax or args.checkpoint_dir), \
            "--value-cols>1 composes with neither --minmax nor " \
            "--checkpoint-dir yet"
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    # bench-bigjoin --outer has no distributed form: the reference runs it
    # on one device whatever --distributed says
    mesh = None
    if args.distributed and getattr(args, "outer", None) is None:
        from tpu_qe_torch.exchange.mesh import make_mesh
        if cmd == "bigagg":
            assert args.value_cols == 1, \
                "--value-cols applies to the single-chip path"
        if cmd == "bigwindow":
            assert args.checkpoint_dir is None, \
                "--checkpoint-dir applies to the single-chip path"
        mesh = make_mesh(args.devices, dev)

    def call(warm: bool, **kw):
        if mesh is None:
            kw.pop("stats", None)
            return single(args, dev, warm, **kw)
        return dist(args, mesh, warm, **kw)

    kw = {"verbose": args.verbose_big}
    if cmd in ("bigagg", "bigjoin", "bigwindow") and args.checkpoint_dir:
        os.makedirs(args.checkpoint_dir, exist_ok=True)
        kw["checkpoint_dir"] = args.checkpoint_dir
    compile_s = _build_seconds(dev)
    if cuda:
        # an untimed run of the same path at a small size: the timed run
        # pays neither the kernels' build nor any kernel's first launch
        call(True)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    before = sum(driver.RADIX_PASSES.values())
    stats = {}
    res = call(False, stats=stats, **kw)
    row = make_row(args, res, "1 card" if mesh is None
                   else f"{mesh.n_dev} devices")
    row["sort_passes"] = sum(driver.RADIX_PASSES.values()) - before
    if mesh is not None:
        # at D = 1 the call delegates unless --force-composed (the
        # quantile path always runs composed)
        row.update({"devices": mesh.n_dev, "mesh": repr(mesh),
                    "composed": (mesh.n_dev > 1 or args.force_composed
                                 or cmd == "bigquantile")})
        moved = next((stats[k] for k in _MOVED if k in stats), None)
        if moved is not None:
            row["balance"] = max(moved) / (sum(moved) / len(moved))
    if not cuda:
        for k in row:
            if k == "time_s" or k == "value" or k.startswith("phase_"):
                row[k] = "not measured"
        row["device"] = "cpu"
        return row
    from tpu_qe_torch.bench.sol import card
    info = card()
    sol = None if mesh is not None else _sol(cmd, args, res)
    row.update({
        "compile_s": compile_s,
        "sol_fraction": None if sol is None else sol / res.seconds,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
        "device": info["name"], "power_limit": info["power_limit"]})
    if args.trace_dir:
        from tpu_qe_torch.bench.big import profile
        row["profile"] = profile(args.trace_dir, res.seconds,
                                 lambda: call(False))
    return row


def main(cmd: str, args) -> int:
    row = run(cmd, args)
    print(json.dumps(row), flush=True)
    return 0 if row["verified"] else 1
