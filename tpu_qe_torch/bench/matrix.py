"""Benchmark matrix: the operator configs of tpu_qe/bench/matrix.py on the
card, radix backend beside the torch.sort baseline.

    python -m tpu_qe_torch bench-matrix [--configs filter_agg,join]
        [--scale 1.0] [--device cuda] [--trace-dir DIR]

Configs, at the JAX package's default sizes (scaled by --scale):
  pipeline        morton-encode 2^26 points + sort (code, index)
  filter_agg      filter val < 2^30 (25 % of uniform u32 values; the JAX
                  docstring's "~50 %" does not match its own predicate) +
                  GROUP BY count, sum over 2^28 rows and 2^20 groups
                  (BASELINE.json config 3)
  join            FK scan-join, 100M left rows probing 100M unique right
                  keys (BASELINE.json config 4)
  join_agg        join -> GROUP BY sum over 100M x 100M, fused through the
                  key-sorted stream and unfused (two rows)
  orderby         ORDER BY a DESC, b, f DESC (+ payload) over 2^27 rows
  count_distinct  GROUP BY COUNT(DISTINCT value) over 2^27 rows
  setop           INTERSECT of 2^27 and 2^26 u64 keys
  window          row_number + rank + exact running sum, then a centered
                  ROWS frame (moving_sum 4 back, 3 ahead) + the tie-aware
                  unbounded RANGE sum, over 2^27 rows and 2^16 partitions
                  (two rows)
  quantile        per-group exact PERCENTILE_DISC p50 + p99 over 2^27 rows
                  and 2^14 groups, max_groups = 2^14
  dsort           distributed sample sort of 2^26 Zipf-ish u64 keys + an
                  arange payload at capacity_factor 4 over the mesh of
                  exchange.make_mesh() (one shard per card), or with
                  --devices N a LocalMesh of N shards on the one device:
                  then one device does every shard's work and its
                  all_to_all is a copy in device memory, so the time is no
                  multi-card figure

Data is made on the device from seeded torch.Generators in the JAX
package's shapes (the numbers differ from jax.random's). Each config runs
once per backend; the outputs must agree bit for bit and pass the
config's invariants (`checks`). Then each backend is timed over REPS
calls with CUDA events. One JSON row per config: rows/s and time of the
radix backend, the torch backend's beside it, `sol_fraction` (the port's
envelope, bench/sol.py, over the radix time), peak device memory of each
backend's first run, the LSD passes of one radix run (as the sort driver
recorded them) and the number of radix runs, and the card. On a CPU
device the checks run and every time is "not measured".

With --trace-dir, one more radix run per config is profiled
(torch.profiler): its Chrome trace goes to DIR/<config>-<row>.json and the
row gains `profile`: the run's wall time, the summed kernel time, the
device's idle share (1 - kernel time / wall) and the kernel time by
category (CATEGORIES). Trace ranges are not kernels and are left out.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from collections import Counter
from typing import Callable

import torch

from tpu_qe_torch.bench.sol import operator_sol_seconds
from tpu_qe_torch.bits import U64, is_sorted_u64, mul_lo32, narrow, widen
from tpu_qe_torch.config import resolve_device
from tpu_qe_torch.sort import driver
from tpu_qe_torch.table import Table, from_plane, plane

DEFAULT_ROWS = {"pipeline": 1 << 26, "filter_agg": 1 << 28,
                "join": 100_000_000, "join_agg": 100_000_000,
                "orderby": 1 << 27, "count_distinct": 1 << 27,
                "setop": 1 << 27, "window": 1 << 27, "quantile": 1 << 27,
                "dsort": 1 << 26}
GOLDEN = 2654435761          # the JAX matrix's multiplicative key mix
REPS = 2                     # timed calls per backend

# Device-time categories of a profiled run: substrings of kernel names,
# the first match wins; every other kernel is "elementwise/other". The
# port's own kernels live in an anonymous namespace.
CATEGORIES = (
    ("B1 histogram", ("namespace)::histogram_kernel",
                      "namespace)::histogram_group_kernel")),
    ("B2 scan", ("namespace)::scan_kernel",)),   # its memset: "copies"
    ("B3 rank+scatter", ("namespace)::rank_kernel",
                         "namespace)::rank_wide_kernel",
                         "namespace)::scatter_wide_kernel")),
    ("sort (torch)", ("RadixSort", "radixSort", "sort", "Sort")),
    ("scans (cumsum, cummax)", ("Scan", "scan", "cummax", "cumsum")),
    ("gathers, scatters", ("index_elementwise_kernel", "index_put",
                           "gather", "scatter")),
    ("copies", ("Memcpy", "Memset")),
)


@dataclasses.dataclass
class Config:
    """One benchmark row: `run(backend)` returns the outputs to compare
    across backends, `checks(outputs)` the config's invariants, `scans`
    the one-plane scans over `rows` that its envelope counts."""

    metric: str
    rows: int
    run: Callable[[str], dict]
    checks: Callable[[dict], dict]
    scans: int
    extra: dict = dataclasses.field(default_factory=dict)
    report: Callable[[dict], dict] | None = None   # more of the row


def _gen(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def rand_u32(n: int, g: torch.Generator, device) -> torch.Tensor:
    """n uniform u32 values as an int32 plane."""
    return narrow(torch.randint(0, 1 << 32, (n,), generator=g, device=device,
                                dtype=torch.int64))


def _mixed_key(ids: torch.Tensor, hi_shift: int) -> U64:
    """The JAX matrix's group key: (id * 2654435761 mod 2^32, id >> s)."""
    return U64(narrow(mul_lo32(ids, GOLDEN)), narrow(ids >> hi_shift))


def _u64_total(s: U64, ng) -> torch.Tensor:
    """Sum of the first ng u64 values (each < 2^63 / ng) as int64."""
    return (widen(s.hi[:ng]) * (1 << 32) + widen(s.lo[:ng])).sum()


def _group_outputs(res) -> dict:
    out = {"num_groups": res.num_groups, "key_lo": res.key.lo,
           "key_hi": res.key.hi}
    for a, v in res.aggs.items():
        if isinstance(v, U64):
            out[f"{a}_lo"], out[f"{a}_hi"] = v.lo, v.hi
        else:
            out[a] = v.view(torch.int32) if v.dtype == torch.uint32 else v
    return out


# ------------------------------------------------------------------ configs

def filter_agg_data(n: int, device, groups: int = 1 << 20) -> dict:
    g = _gen(device, 7)
    gid = torch.randint(0, groups, (n,), generator=g, device=device)
    key = _mixed_key(gid, 13)
    del gid
    return {"key": key, "val": from_plane(rand_u32(n, g, device),
                                          torch.uint32), "groups": groups}


def filter_agg_op(data: dict, backend: str):
    """WHERE val < 2^30 GROUP BY key: count, exact u64 sum (the filter
    fused into the aggregation sort as a valid mask, as in JAX)."""
    from tpu_qe_torch.ops.aggregate import group_aggregate
    valid = widen(plane(data["val"])) < (1 << 30)
    return group_aggregate(data["key"], data["val"], ("count", "sum"),
                           valid=valid, backend=backend), valid


def _filter_agg(n: int, device) -> list[Config]:
    data = filter_agg_data(n, device)

    def run(backend):
        return _group_outputs(filter_agg_op(data, backend)[0])

    def checks(out):
        valid = widen(plane(data["val"])) < (1 << 30)
        ng = int(out["num_groups"])
        selected = widen(plane(data["val"]))[valid]
        return {
            "counts_sum_to_selected_rows":
                int(out["count"][:ng].sum()) == int(valid.sum()),
            "u64_sum_total_equals_int64_sum":
                int(_u64_total(U64(out["sum_lo"], out["sum_hi"]), ng))
                == int(selected.sum()),
            "groups_within_bound": 0 < ng <= data["groups"],
        }

    return [Config(f"filter + group aggregate, {n} rows, 1 card", n, run,
                   checks, 4,
                   {"groups": data["groups"], "selectivity": 0.25})]


def join_data(n: int, device, seed: int = 3, groups: int | None = None):
    """Unique right keys (a bijective mix of arange), random u32 values,
    left keys picked from the right keys (among the first `groups`)."""
    r = torch.arange(n, device=device)
    rkey = U64(narrow(mul_lo32(r, GOLDEN) ^ 0x9E3779B9), narrow(r))
    g = _gen(device, seed)
    rval = rand_u32(n, g, device)
    pick = torch.randint(0, groups or n, (n,), generator=g, device=device)
    lkey = U64(rkey.lo[pick], rkey.hi[pick])
    return {"rkey": rkey, "rval": from_plane(rval, torch.uint32),
            "pick": pick, "lkey": lkey}


def join_op(data: dict, backend: str):
    from tpu_qe_torch.ops.join import join_fk_scan
    n = data["lkey"].lo.shape[0]
    left = Table({"li": from_plane(torch.arange(
        n, dtype=torch.int32, device=data["pick"].device), torch.uint32)})
    return join_fk_scan(left, Table({"rval": data["rval"]}), data["lkey"],
                        data["rkey"], backend=backend)


def _join(n: int, device) -> list[Config]:
    data = join_data(n, device)

    def run(backend):
        out, matched = join_op(data, backend)
        return {"matched": matched, "rval": plane(out["rval"])}

    def checks(out):
        want = plane(data["rval"])[data["pick"]]
        return {"every_left_row_matches": bool(out["matched"].all()),
                "values_are_the_picked_right_rows":
                    bool(torch.equal(out["rval"], want))}

    return [Config(f"fk scan-join, {n} x {n} rows, 1 card", 2 * n, run,
                   checks, 4)]


def join_agg_op(data: dict, backend: str, fused: bool):
    from tpu_qe_torch.ops.aggregate import (group_aggregate,
                                            group_aggregate_sorted)
    from tpu_qe_torch.ops.join import join_fk_scan
    n = data["lkey"].lo.shape[0]
    left = Table({"z": torch.zeros(n, dtype=torch.int32,
                                   device=data["pick"].device)})
    right = Table({"rval": data["rval"]})
    if fused:
        st = join_fk_scan(left, right, data["lkey"], data["rkey"],
                          output="stream", backend=backend)
        return group_aggregate_sorted(st.key, st.values["rval"],
                                      ("count", "sum"), valid=st.matched)
    out, matched = join_fk_scan(left, right, data["lkey"], data["rkey"],
                                backend=backend)
    return group_aggregate(data["lkey"], out["rval"], ("count", "sum"),
                           valid=matched, backend=backend)


def _join_agg(n: int, device) -> list[Config]:
    groups = max(n // 64, 1)
    data = join_data(n, device, seed=9, groups=groups)

    def checks(out):
        ng = int(out["num_groups"])
        picked = torch.bincount(data["pick"], minlength=groups)
        want_sum = widen(plane(data["rval"]))[data["pick"]].sum()
        return {
            "groups_are_the_distinct_picks": ng == int((picked > 0).sum()),
            "counts_sum_to_left_rows": int(out["count"][:ng].sum()) == n,
            "u64_sum_total_equals_int64_sum":
                int(_u64_total(U64(out["sum_lo"], out["sum_hi"]), ng))
                == int(want_sum),
        }

    rows = []
    for fused, label in ((False, "unfused"), (True, "fused stream")):
        rows.append(Config(
            f"join + GROUP BY sum ({label}), {n} x {n} rows, 1 card", n,
            lambda b, f=fused: _group_outputs(join_agg_op(data, b, f)),
            checks, 6 if fused else 8, {"groups": groups, "fused": fused}))
    return rows


def _pipeline(n: int, device) -> list[Config]:
    from tpu_qe_torch import morton
    from tpu_qe_torch.sort import sort_u64
    g = _gen(device, 11)
    x, y, z = (torch.rand(n, generator=g, device=device) * 200 - 100
               for _ in range(3))
    params = morton.MortonParams.for_scene([-100.0] * 3, [100.0] * 3,
                                           device)

    def run(backend):
        code = morton.encode_points(x, y, z, params)
        idx = torch.arange(n, dtype=torch.int32, device=device)
        skey, (sidx,) = sort_u64(code, idx, backend=backend)
        return {"lo": skey.lo, "hi": skey.hi, "idx": sidx}

    def checks(out):
        return {"keys_sorted": bool(is_sorted_u64(out["lo"], out["hi"])),
                "index_is_a_permutation": bool(
                    (torch.bincount(out["idx"], minlength=n) == 1).all())}

    return [Config(f"morton encode + sort pipeline, {n} points, 1 card", n,
                   run, checks, 3)]


def _orderby(n: int, device) -> list[Config]:
    from tpu_qe_torch.ops.orderby import sort_by_multi
    g = _gen(device, 21)
    t = Table({
        "a": U64(rand_u32(n, g, device) & 0xFFF,
                 torch.zeros(n, dtype=torch.int32, device=device)),
        "b": rand_u32(n, g, device),
        "f": torch.randn(n, generator=g, device=device),
        "pay": from_plane(rand_u32(n, g, device), torch.uint32),
    })
    by = [("a", "desc"), "b", ("f", "desc")]

    def run(backend):
        st = sort_by_multi(t, by, backend=backend)
        return {"a_lo": st["a"].lo, "a_hi": st["a"].hi, "b": st["b"],
                "f": st["f"].view(torch.int32), "pay": plane(st["pay"])}

    def checks(out):
        a = widen(out["a_lo"])
        return {"a_descending": bool((a[:-1] >= a[1:]).all())}

    return [Config(f"ORDER BY a DESC, b, f DESC (+payload), {n} rows, 1 card",
                   n, run, checks, 0)]


def _count_distinct(n: int, device) -> list[Config]:
    from tpu_qe_torch.ops.aggregate import group_aggregate
    groups = 1 << 14
    g = _gen(device, 22)
    key = _mixed_key(torch.randint(0, groups, (n,), generator=g,
                                   device=device), 7)
    val = from_plane(rand_u32(n, g, device) & 0x3FF, torch.uint32)

    def run(backend):
        return _group_outputs(group_aggregate(
            key, val, ("count", "count_distinct"), backend=backend))

    def checks(out):
        ng = int(out["num_groups"])
        cd = out["count_distinct"][:ng]
        return {"counts_sum_to_rows": int(out["count"][:ng].sum()) == n,
                "distinct_within_bounds": bool(
                    ((cd >= 1) & (cd <= 1024) & (cd <= out["count"][:ng]))
                    .all())}

    return [Config(f"GROUP BY COUNT(DISTINCT), {n} rows, 1 card", n, run,
                   checks, 3, {"groups": groups})]


def _setop(n: int, device) -> list[Config]:
    from tpu_qe_torch.ops.setops import set_op
    g = _gen(device, 29)
    m = n // 2
    zeros = torch.zeros(n, dtype=torch.int32, device=device)
    a = U64(rand_u32(n, g, device) & 0x3FFFFF, zeros)
    b = U64(rand_u32(m, g, device) & 0x3FFFFF, zeros[:m])

    def run(backend):
        keys, ca, cb, num = set_op(a, b, "intersect", backend=backend)
        return {"lo": keys.lo, "hi": keys.hi, "ca": ca, "cb": cb,
                "num": num}

    def checks(out):
        k = int(out["num"])
        return {"both_sides_present": bool(((out["ca"][:k] > 0)
                                            & (out["cb"][:k] > 0)).all()),
                "counts_within_sides": int(out["ca"].sum()) <= n
                and int(out["cb"].sum()) <= m}

    return [Config(f"INTERSECT {n} vs {m} u64 keys, 1 card", n + m, run,
                   checks, 3)]


def window_data(n: int, device, partitions: int = 1 << 16) -> dict:
    """The JAX window config's shapes: partition key (pid * 2654435761,
    pid >> 9), random u32 order and value."""
    g = _gen(device, 13)
    pid = torch.randint(0, partitions, (n,), generator=g, device=device)
    return {"key": _mixed_key(pid, 9), "pid": pid.to(torch.int32),
            "order": from_plane(rand_u32(n, g, device), torch.uint32),
            "val": from_plane(rand_u32(n, g, device), torch.uint32),
            "partitions": partitions}


WINDOW_FUNCS = ({"rn": ("row_number",), "rk": ("rank",),
                 "cum": ("running_sum", "v")},
                {"cs": ("moving_sum", "v", 4, 3),
                 "ru": ("range_sum", "v", "unbounded")})


def window_op(data: dict, funcs: dict, backend: str):
    from tpu_qe_torch.ops.window import window
    return window(data["key"], funcs, order=data["order"],
                  values={"v": data["val"]}, backend=backend)


def _per_partition(data: dict, x: torch.Tensor, how: str) -> torch.Tensor:
    """Per-partition max ("amax") or sum ("sum") of int64 row values."""
    out = torch.zeros(data["partitions"], dtype=torch.int64,
                      device=x.device)
    return out.scatter_reduce_(0, data["pid"].to(torch.int64), x, how)


def _window(n: int, device) -> list[Config]:
    data = window_data(n, device)
    val = widen(plane(data["val"]))
    sizes = _per_partition(data, torch.ones_like(val), "sum")
    totals = _per_partition(data, val, "sum")

    def run(funcs, backend):
        out = {}
        for name, c in window_op(data, funcs, backend).cols.items():
            if isinstance(c, U64):
                out[f"{name}_lo"], out[f"{name}_hi"] = c.lo, c.hi
            else:
                out[name] = plane(c)
        return out

    def u64(out, name):
        return widen(out[f"{name}_hi"]) * (1 << 32) + widen(out[f"{name}_lo"])

    def ends_at_totals(out, name):
        # values are >= 0: a partition's largest running sum is its total
        return bool(torch.equal(_per_partition(data, u64(out, name), "amax"),
                                totals))

    def checks_rank(out):
        rn, rk = widen(out["rn"]), widen(out["rk"])
        return {
            "row_numbers_reach_partition_sizes": bool(torch.equal(
                _per_partition(data, rn, "amax"), sizes)),
            "rank_within_row_number": bool(((rk >= 1) & (rk <= rn)).all()),
            "running_sums_end_at_partition_totals": ends_at_totals(out,
                                                                   "cum"),
        }

    def checks_frames(out):
        cs = u64(out, "cs")
        return {
            "frame_sums_hold_their_row_and_at_most_eight": bool(
                ((cs >= val) & (cs <= 8 * 0xFFFFFFFF)).all()),
            "range_sums_end_at_partition_totals": ends_at_totals(out, "ru"),
        }

    # scans: one-plane scans of the envelope; the int64 running max and sum
    # of a row index or value count as two planes each
    return [Config(f"window {label}, {n} rows, 1 card", n,
                   lambda b, f=funcs: run(f, b), checks, scans,
                   {"partitions": data["partitions"]})
            for funcs, checks, scans, label in (
                (WINDOW_FUNCS[0], checks_rank, 6, "rn+rank+running_sum"),
                (WINDOW_FUNCS[1], checks_frames, 10,
                 "centered frame + RANGE unbounded"))]


def quantile_data(n: int, device, groups: int = 1 << 14) -> dict:
    """The JAX quantile config's shapes: group key (g * 2654435761,
    g >> 7) and a random u32 value."""
    g = _gen(device, 23)
    gid = torch.randint(0, groups, (n,), generator=g, device=device)
    return {"key": _mixed_key(gid, 7),
            "present": int((torch.bincount(gid, minlength=groups) > 0)
                           .sum()),
            "val": from_plane(rand_u32(n, g, device), torch.uint32),
            "groups": groups}


QUANTILES = [(1, 1), 0.99]


def quantile_op(data: dict, backend: str):
    from tpu_qe_torch.ops.quantile import group_quantile
    return group_quantile(data["key"], data["val"], QUANTILES,
                          max_groups=data["groups"], backend=backend)


def _quantile(n: int, device) -> list[Config]:
    data = quantile_data(n, device)

    def run(backend):
        res = quantile_op(data, backend)
        return {"num_groups": res.num_groups, "overflow": res.overflow,
                "key_lo": res.key.lo, "key_hi": res.key.hi,
                "count": res.count, "q": plane(res.quantiles)}

    def checks(out):
        ng = int(out["num_groups"])
        q = widen(out["q"][:, :ng])
        return {
            "groups_are_the_present_ids": ng == data["present"]
            and int(out["overflow"]) == 0,
            "counts_sum_to_rows": int(out["count"].sum()) == n,
            "keys_ascending": bool(is_sorted_u64(out["key_lo"][:ng],
                                                 out["key_hi"][:ng])),
            "p50_at_most_p99": bool((q[0] <= q[1]).all()),
        }

    return [Config(f"GROUP BY p50+p99 (exact), {n} rows, 1 card", n, run,
                   checks, 2, {"groups": data["groups"]})]


def dsort_data(n: int, device) -> dict:
    """The JAX dsort config's keys: u uniform in [0, 1), skew = u^4 * 2^30
    (mass near zero), lo = skew * 2654435761 mod 2^32, hi = skew >> 8;
    payload arange(n)."""
    u = torch.rand(n, generator=_gen(device, 5), device=device)
    skew = (u ** 4 * float(1 << 30)).to(torch.int64)
    return {"key": U64(narrow(mul_lo32(skew, GOLDEN)), narrow(skew >> 8)),
            "pay": torch.arange(n, dtype=torch.int32, device=device)}


def _dsort(n: int, device, devices: int | None = None) -> list[Config]:
    from tpu_qe_torch.exchange.dsort import distributed_sort
    from tpu_qe_torch.exchange.mesh import LocalMesh, make_mesh
    mesh = (make_mesh(device=device) if devices is None
            else LocalMesh(devices, device))
    d = mesh.n_dev
    n -= n % d
    data = dsort_data(n, device)
    key = U64(mesh.shard(data["key"].lo), mesh.shard(data["key"].hi))
    pay = mesh.shard(data["pay"])

    def run(backend):
        res, overflow = distributed_sort(key, pay, mesh=mesh,
                                         capacity_factor=4.0,
                                         backend=backend)
        return {"lo": res.key.lo, "hi": res.key.hi,
                "pay": res.payloads[0], "valid": res.valid,
                "overflow": overflow}

    def checks(out):
        valid = out["valid"].tolist()
        lo, hi, p = (torch.cat([out[c][s, :v] for s, v in enumerate(valid)])
                     for c in ("lo", "hi", "pay"))
        same = (lo[1:] == lo[:-1]) & (hi[1:] == hi[:-1])
        perm = (sum(valid) == n
                and bool((torch.bincount(p, minlength=n) == 1).all()))
        return {"keys_sorted_across_shards": bool(is_sorted_u64(lo, hi)),
                "payload_is_a_stable_permutation":
                    perm and bool((p[1:][same] > p[:-1][same]).all()),
                "valid_sums_to_rows": sum(valid) == n,
                "no_overflow": int(out["overflow"].max()) == 0}

    def report(out):      # the balance the splitters reached
        return {"balance": int(out["valid"].max()) / (n // d)}

    return [Config(f"distributed sample-sort, {n} u64 keys (zipf), {d} "
                   f"shard(s) on one device",
                   n, run, checks, 3, {"devices": d}, report)]


BUILDERS = {"pipeline": _pipeline, "filter_agg": _filter_agg, "join": _join,
            "join_agg": _join_agg, "orderby": _orderby,
            "count_distinct": _count_distinct, "setop": _setop,
            "window": _window, "quantile": _quantile, "dsort": _dsort}


# ------------------------------------------------------------------- runner

def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _category(kernel: str) -> str:
    for cat, keys in CATEGORIES:
        if any(k in kernel for k in keys):
            return cat
    return "elementwise/other"


def profile(cfg: Config, device: torch.device, path: str) -> dict:
    """One radix run under torch.profiler, its Chrome trace written to
    `path`: wall time, kernel time, idle share and kernel time by
    category."""
    from tpu_qe_torch.utils.profiling import trace_session
    cuda = device.type == "cuda"
    with trace_session(os.path.dirname(path), os.path.basename(path)) as prof:
        t0 = time.perf_counter()
        cfg.run("radix")
        if cuda:
            torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    if not cuda:
        return {"trace": path, "wall_ms": wall_ms,
                "device_busy_ms": "not measured",
                "idle_share": "not measured"}
    return {"trace": path, **device_time(prof, wall_ms)}


def device_time(prof, wall_ms: float) -> dict:
    """Kernel time of a CUDA profile over a run of `wall_ms`: the summed
    kernel time, the device's idle share (1 - kernel time / wall) and the
    kernel time by category (CATEGORIES) and for the largest kernels."""
    events = prof.events()
    # a trace range shows on the device too, under its host-side name
    ranges = {e.name for e in events
              if e.device_type != torch.autograd.DeviceType.CUDA}
    by_cat, by_kernel = Counter(), Counter()
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.name not in ranges):
            ms = e.time_range.elapsed_us() / 1e3
            by_cat[_category(e.name)] += ms
            by_kernel[e.name[:80]] += ms
    busy = sum(by_cat.values())
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall_ms,
            "by_category_ms": dict(by_cat.most_common()),
            "top_kernels_ms": dict(by_kernel.most_common(6))}


def measure(cfg: Config, device: torch.device, card: dict | None,
            trace: str | None = None) -> dict:
    """Run, compare and time one config; returns its JSON row. `trace`
    names the Chrome trace of a profiled radix run (none if None)."""
    cuda = device.type == "cuda"
    outs, peak = {}, {}
    for backend in ("radix", "torch"):
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        driver.RADIX_PASSES.clear()
        outs[backend] = cfg.run(backend)
        if backend == "radix":
            plan = Counter(driver.RADIX_PASSES)
        if cuda:
            torch.cuda.synchronize(device)
            peak[backend] = torch.cuda.max_memory_allocated(device)
    checks = {"backend_parity": _same(outs["radix"], outs["torch"])}
    checks.update(cfg.checks(outs["radix"]))
    row = {"metric": cfg.metric, "rows": cfg.rows,
           "sort_passes": sum(plan.values()), "radix_runs": 1,
           "checks": checks, **cfg.extra,
           **(cfg.report(outs["radix"]) if cfg.report else {})}
    del outs
    if cuda:
        from tpu_qe_torch.utils.timing import cuda_time
        t_radix = cuda_time(lambda: cfg.run("radix"), iters=REPS, warmup=0)
        t_torch = cuda_time(lambda: cfg.run("torch"), iters=REPS, warmup=0)
        sol = operator_sol_seconds(plan, cfg.scans, cfg.rows)
        row.update({
            "value": cfg.rows / t_radix, "unit": "rows/s", "time_s": t_radix,
            "torch_time_s": t_torch, "torch_rows_per_s": cfg.rows / t_torch,
            "vs_torch": t_torch / t_radix, "sol_fraction": sol / t_radix,
            "peak_mem_bytes": peak["radix"],
            "torch_peak_mem_bytes": peak["torch"], "radix_runs": 1 + REPS,
            "device": card["name"], "power_limit": card["power_limit"]})
    else:
        row.update({"value": "not measured", "unit": "rows/s",
                    "time_s": "not measured", "device": "cpu"})
    if trace:
        row["profile"] = profile(cfg, device, trace)
        row["radix_runs"] += 1
    return row


def rows_for(name: str, scale: float) -> int:
    return max(int(DEFAULT_ROWS[name] * scale), 1 << 12)


def run(configs, scale: float = 1.0, device: str = "cuda",
        trace_dir: str | None = None,
        devices: int | None = None) -> list[dict]:
    """Measure each named config; prints and returns the JSON rows.
    `devices` sizes the dsort config's mesh: a LocalMesh of that many
    shards on the device (default: exchange.make_mesh())."""
    dev = resolve_device(device)
    for c in configs:
        if c not in BUILDERS:
            raise SystemExit(f"bench-matrix: unknown config {c!r}")
    card = None
    if dev.type == "cuda":
        from tpu_qe_torch.bench.sol import card as card_info
        card = card_info()
    out = []
    for c in configs:
        kw = {"devices": devices} if c == "dsort" else {}
        for i, cfg in enumerate(BUILDERS[c](rows_for(c, scale), dev, **kw)):
            trace = (os.path.join(trace_dir, f"{c}-{i}.json") if trace_dir
                     else None)
            row = {"config": c, **measure(cfg, dev, card, trace)}
            print(json.dumps(row), flush=True)
            out.append(row)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(configs, scale: float = 1.0, device: str = "cuda",
         trace_dir: str | None = None, devices: int | None = None) -> int:
    """The bench-matrix subcommand: 0 when every check of every row
    holds, else 1."""
    rows = run(configs, scale, device, trace_dir, devices)
    failed = [(r["config"], k) for r in rows for k, ok in r["checks"].items()
              if not ok]
    if failed:
        print(f"bench-matrix: checks failed: {failed}", file=sys.stderr)
        return 1
    return 0
