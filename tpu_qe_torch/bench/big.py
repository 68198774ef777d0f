"""bench-big: the out-of-core sort of sort/bigsort.py at the north-star
size, one JSON line.

    python -m tpu_qe_torch bench-big [--n 2^30] [--run-size 2^26]
        [--buckets B] [--in-core] [--strategy partition|merge]
        [--distributed [--devices D] [--force-composed]]
        [--payload-cols P] [--checkpoint-dir DIR] [--trace-dir DIR]
        [--verbose-big] [--device cuda]

The line has the JAX package's fields (keys/s, time, phase times, compile
time, the certificates and `sol_fraction` against the port's envelope,
bench/sol.bigsort_sol_seconds, for the out-of-core paths), plus the plan's
time, the peak device memory and the card's name and power limit. On the
card an untimed run of the same path at 2^18 keys comes first (the build
and the kernels' first launches). With --trace-dir one more run is
profiled (torch.profiler, DIR/trace.json) and the line gains `profile`:
that run's wall time, its summed kernel time and idle share, and the
kernel time by category (bench/matrix.CATEGORIES). On a CPU device the
certificates hold the same and every time is "not measured". Exit 0 when
every certificate holds, else 1.

--distributed runs the distributed out-of-core sort (sort/dbigsort.py)
over make_mesh(--devices) on the device: one shard per card by default,
a LocalMesh of D shards on the device with --devices D. --buckets is then
per shard. At D = 1 the call delegates to sort_big unless
--force-composed; `kind` says which path ran. The line adds `devices` and
`balance` (the most rows a shard holds over n / D); on a LocalMesh of
D > 1 the time is one card doing every shard's work.
"""

from __future__ import annotations

import json
import os
import time

import torch

from tpu_qe_torch.config import resolve_device


WARMUP_N, WARMUP_RUN = 1 << 18, 1 << 14


def _sort(args, dev, n: int, run_size: int, buckets: int, mesh=None,
          stats=None, **kw):
    from tpu_qe_torch.sort.bigsort import sort_big, sort_big_incore
    if args.in_core:
        return sort_big_incore(n, device=dev)
    if mesh is not None:
        from tpu_qe_torch.sort.dbigsort import sort_big_distributed
        return sort_big_distributed(
            n, mesh, run_size=run_size, buckets_per_dev=args.buckets,
            force_composed=args.force_composed,
            payload_cols=args.payload_cols, stats=stats, **kw)
    return sort_big(n, run_size=run_size, n_buckets=buckets,
                    payload_cols=args.payload_cols, strategy=args.strategy,
                    device=dev, **kw)


def run(args) -> dict:
    assert args.payload_cols >= 1, "--payload-cols must be >= 1"
    assert args.payload_cols == 1 or not args.in_core, \
        "--payload-cols > 1 applies to the out-of-core paths"
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    buckets = args.buckets or max(2, -(-args.n // (1 << 26)))
    if args.checkpoint_dir:
        os.makedirs(args.checkpoint_dir, exist_ok=True)
    mesh = None
    warm_n = WARMUP_N
    if args.distributed and not args.in_core:
        from tpu_qe_torch.exchange.mesh import make_mesh
        mesh = make_mesh(args.devices, dev)
        warm_n = mesh.n_dev * 2 * WARMUP_RUN
    # which path runs: at D = 1 without --force-composed the distributed
    # call delegates to sort_big
    composed = mesh is not None and (mesh.n_dev > 1 or args.force_composed)
    compile_s = 0.0
    if cuda:
        # one untimed run of the same path at 2^18 keys: the timed run pays
        # neither the kernels' build nor any kernel's first launch, as the
        # JAX package's timed run pays no compile
        compile_s = _sort(args, dev, warm_n, WARMUP_RUN, buckets,
                          mesh).compile_s
        torch.cuda.reset_peak_memory_stats(dev)
    stats = {}
    res = _sort(args, dev, args.n, args.run_size, buckets, mesh, stats,
                verbose=args.verbose_big, checkpoint_dir=args.checkpoint_dir)
    if args.in_core:
        kind, where = "in-core", "1 card"
    elif mesh is not None:
        kind = ("distributed out-of-core" if composed
                else "out-of-core (D=1 delegated)")
        where = f"{mesh.n_dev} shard(s), {mesh}"
    else:
        kind, where = f"out-of-core [{args.strategy}]", "1 card"
    if args.payload_cols > 1:
        kind += f" ({args.payload_cols}-col rows)"
    row = {
        "metric": f"{kind} sort {res.n} u64 keys + u32 payload, {where}",
        "verified": res.all_ok,
        "checks": {"sorted": res.sorted_ok, "hash": res.hash_ok,
                   "count": res.count_ok, "perm": res.perm_ok,
                   "boundary": res.boundary_ok},
        "unit": "keys/s",
    }
    if mesh is not None:
        rows = stats.get("shard_rows") or [res.n]
        row.update({"devices": mesh.n_dev,
                    "balance": max(rows) / (res.n / len(rows))})
    if not cuda:
        row.update({"value": "not measured", "time_s": "not measured",
                    "device": "cpu"})
        return row
    from tpu_qe_torch.bench.sol import bigsort_sol_seconds, card
    info = card()
    if composed:
        # the composed path sorts every run, then every bucket (the merge
        # strategy's envelope over D * B buckets; the exchange's copies
        # are left out)
        sol = bigsort_sol_seconds(
            res.n, args.run_size, mesh.n_dev * (args.buckets or max(
                1, -(-res.n // mesh.n_dev // (1 << 26)))),
            args.payload_cols, "merge")
    else:
        sol = None if args.in_core else bigsort_sol_seconds(
            res.n, args.run_size, buckets, args.payload_cols, args.strategy)
    row.update({
        "value": res.keys_per_s, "time_s": res.seconds,
        "phase_runs_s": res.phase_a_s,
        "phase_plan_s": res.seconds - res.phase_a_s - res.phase_c_s,
        "phase_merge_s": res.phase_c_s, "compile_s": compile_s,
        "sol_fraction": None if sol is None else sol / res.seconds,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
        "device": info["name"], "power_limit": info["power_limit"]})
    if args.trace_dir:
        row["profile"] = profile(
            args.trace_dir,
            lambda: _sort(args, dev, args.n, args.run_size, buckets, mesh))
    return row


def profile(trace_dir: str, run) -> dict:
    """One more run of the path (`run()`, no checkpoint) under
    torch.profiler: its kernel time by category and its idle share (1 -
    kernel time / its time)."""
    from tpu_qe_torch.bench.matrix import device_time
    from tpu_qe_torch.utils.profiling import trace_session
    with trace_session(trace_dir) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return {"trace": os.path.join(trace_dir, "trace.json"),
            **device_time(prof, wall_ms)}


def main(args) -> int:
    row = run(args)
    print(json.dumps(row), flush=True)
    return 0 if row["verified"] else 1
