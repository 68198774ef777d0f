#!/usr/bin/env python
"""End-to-end analytics walkthrough on tpu_qe_torch, the PyTorch/CUDA port
of the query engine: the steps of examples/analytics.py, run on one device
(the card unless --device names another).

A miniature star-schema workload over spatial event data, exercising the
whole operator surface:

  1. morton-encode event coordinates into u64 spatial cell keys
  2. filter events by a predicate (stable compaction)
  3. FK-join events against a dimension table (scan join)
  4. GROUP BY spatial cell with count/sum/mean aggregates
  5. top-k densest cells
  6. the fused join -> GROUP BY over the key-sorted stream
  7. the distributed sort over make_mesh() (one shard per card)
  8. an out-of-core GROUP BY over more rows than one run
  9. window functions, 10. a multi-column ORDER BY, 11. COUNT(DISTINCT)
     and per-group medians, 12. set algebra
 13. SQL, in core and over a mesh of shards (`mesh=`), which must agree
 14. SQL over a virtual (out-of-core) table

Run: python examples/analytics_torch.py [--n 1048576] [--device cuda]

`main(argv)` prints one line a step and returns what it printed: a dict of
step name -> the values on that line (and the arrays they summarise), so
a test can hold each step against the JAX package on the same inputs.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def events(n: int, seed: int = 7) -> dict:
    """The walkthrough's events as numpy columns: x, y, z in [-100, 100),
    a sensor id (u64) and a measurement (u32), the reference's draws."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-100, 100, n).astype(np.float32)
    y = rng.uniform(-100, 100, n).astype(np.float32)
    z = rng.uniform(-100, 100, n).astype(np.float32)
    sensor = rng.integers(0, 1024, n).astype(np.uint64)
    value = rng.integers(1, 100, n, dtype=np.uint32)
    return {"x": x, "y": y, "z": z, "sensor": sensor, "value": value}


SQL = ("SELECT sensor, COUNT(*) AS c, SUM(value) AS s, "
       "MEDIAN(value) AS med FROM events WHERE value > 50 "
       "GROUP BY sensor HAVING COUNT(*) > 2 ORDER BY s DESC LIMIT 5")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="examples/analytics_torch.py")
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from tpu_qe_torch import morton
    from tpu_qe_torch.bits import U64, widen
    from tpu_qe_torch.config import resolve_device
    from tpu_qe_torch.table import Table, from_plane, plane

    dev = resolve_device(args.device)
    n = args.n
    ev_np = events(n)
    out: dict = {}

    def say(step: str, line: str, **vals) -> None:
        print(f"{step + ':':<10}{line}", flush=True)
        out[step] = dict(vals, line=line)

    # --- 1. morton keys of the events' positions -------------------------
    def col(a):
        return torch.from_numpy(a).to(dev)
    params = morton.MortonParams.for_scene(
        np.array([-100.0] * 3, np.float32),
        np.array([100.0] * 3, np.float32), dev)
    fine = morton.encode_points(col(ev_np["x"]), col(ev_np["y"]),
                                col(ev_np["z"]), params)
    # coarsen to the top 12 key bits (~coarse spatial bucket) so cells
    # hold many events: morton keys nest, so masking IS spatial coarsening
    cell = U64(torch.zeros_like(fine.lo),
               fine.hi & (0xFFF00000 - (1 << 32)))   # int32 bit pattern
    base = Table.from_numpy({"value": ev_np["value"],
                             "sensor": ev_np["sensor"]}, device=dev)
    coarse = base.with_column("cell", cell)
    fine_np = fine.to_numpy()
    say("morton", f"{n} events -> {len(np.unique(fine_np))} distinct "
                  f"fine keys, {len(np.unique(cell.to_numpy()))} coarse "
                  "cells", keys=fine_np)

    # --- 2. filter: keep high-value events -------------------------------
    filtered, kept = coarse.filter(
        lambda t: widen(plane(t["value"])) > 20)
    kept = int(kept)
    ev = filtered.head(kept)
    say("filter", f"{kept}/{n} events kept", kept=kept)

    # --- 3. join: attach sensor calibration from a dimension table -------
    sensors = Table.from_numpy({
        "sensor": np.arange(1024, dtype=np.uint64),
        "gain": np.arange(1024, dtype=np.uint32) % 7 + 1}, device=dev)
    joined, matched = ev.join(sensors, key="sensor")
    assert bool(matched.all())
    say("join", f"all {kept} events matched a sensor",
        matched=int(matched.sum()))

    # --- 4. GROUP BY spatial cell ----------------------------------------
    res = joined.group_by("cell", value="gain",
                          aggs=("count", "sum", "mean"))
    g = int(res.num_groups)
    mean0 = float(res.aggs["mean"][0])
    say("group_by", f"{g} occupied cells; mean gain of first cell = "
                    f"{mean0:.3f}", groups=g, mean0=mean0,
        cells=res.key.to_numpy()[:g],
        count=res.aggs["count"][:g].cpu().numpy(),
        sum=res.aggs["sum"].to_numpy()[:g])

    # --- 5. top-k: densest cells (count packed into a sortable u64 key) --
    cnt = res.aggs["count"][:g].to(torch.int32)
    cells = Table({"key": U64(cnt, torch.zeros_like(cnt)),
                   "cell_hi": from_plane(res.key.hi[:g], torch.uint32)})
    top = cells.top_k(5, largest=True)
    dense = top.table.to_numpy()["key"][:5]
    say("top_k", f"densest cells hold {dense.tolist()} events", top=dense)

    # --- 6. fused join -> GROUP BY via the key-sorted stream -------------
    # aggregating the join's key-sorted stream directly
    # (group_aggregate_sorted) skips the join's restore sort and the
    # aggregate's own key sort; integer sums are exact u64 pairs
    from tpu_qe_torch.ops.aggregate import group_aggregate_sorted
    from tpu_qe_torch.ops.join import join_fk_scan
    st = join_fk_scan(Table({"z": torch.zeros(kept, dtype=torch.int32,
                                              device=dev)}),
                      sensors.drop("sensor"), ev["sensor"],
                      sensors["sensor"], output="stream")
    agg = group_aggregate_sorted(st.key, st.values["gain"],
                                 aggs=("count", "sum"), valid=st.matched)
    ng = int(agg.num_groups)
    total = int(agg.aggs["sum"].to_numpy()[:ng].sum())
    gains = np.arange(1024, dtype=np.uint64) % 7 + 1
    ev_sensor = ev["sensor"].to_numpy()
    want = int(gains[ev_sensor].sum())
    assert total == want, (total, want)
    say("fused", f"join+GROUP BY sensor in one sorted stream -> {ng} "
                 f"sensors, total gain {total} (exact u64, verified)",
        sensors=ng, total=total)

    # --- 7. distributed: the same sort over a mesh of shards -------------
    from tpu_qe_torch.exchange import distributed_sort_numpy, make_mesh
    mesh = make_mesh(device=dev)
    d = mesh.n_dev
    keys = fine_np[: (n // d) * d]
    skeys = distributed_sort_numpy(keys, None, mesh, capacity_factor="auto")
    assert (np.sort(keys) == skeys).all()
    say("dsort", f"{len(keys)} keys globally sorted over {d} shard(s)",
        devices=d, keys=skeys)

    # --- 8. out-of-core: GROUP BY more rows than one run -----------------
    from tpu_qe_torch.ops.bigagg import aggregate_big
    big = aggregate_big(1 << 16, n_groups=1 << 10, run_size=1 << 14,
                        minmax=True, device=dev)
    assert big.all_ok, big
    say("bigagg", f"{big.n} rows -> {big.n_groups} groups across "
                  f"{big.n // (1 << 14)} out-of-core runs (count/sum/min/"
                  "max verified on the device)", groups=big.n_groups)

    # --- 9. window functions: per-sensor running analytics ---------------
    win = ev.window("sensor", {"seq": ("row_number",),
                               "cum_val": ("running_sum", "value"),
                               "prev_val": ("lag", "value")},
                    order="value")
    w = win.to_numpy()
    s0 = w["sensor"] == w["sensor"][0]
    assert w["cum_val"][s0].max() == w["value"][s0].astype(np.uint64).sum()
    say("window", f"per-sensor row_number/running-sum/lag over "
                  f"{win.num_rows} rows ({int(w['seq'].max())} rows in the "
                  "busiest sensor)", seq=w["seq"], cum_val=w["cum_val"],
        prev_val=w["prev_val"])

    # --- 10. ORDER BY sensor, value DESC (multi-column, mixed direction) -
    srt = ev.order_by("sensor", ("value", "desc")).to_numpy()
    same_sensor = srt["sensor"][1:] == srt["sensor"][:-1]
    assert (srt["value"][1:][same_sensor]
            <= srt["value"][:-1][same_sensor]).all()
    say("order_by", f"{ev.num_rows} rows by (sensor ASC, value DESC) in "
                    "one lexicographic sort", sensor=srt["sensor"],
        value=srt["value"], cell=srt["cell"])

    # --- 11. COUNT(DISTINCT value) + exact per-sensor median -------------
    cd = ev.group_by("sensor", "value", aggs=("count", "count_distinct"))
    ncd = int(cd.num_groups)
    qres = ev.group_quantile("sensor", "value", [0.5, 0.99])
    klo0 = int(widen(cd.key.lo[0]))
    sel = ev_sensor == klo0
    ev_value = ev.to_numpy()["value"]
    cd0 = int(cd.aggs["count_distinct"][0])
    assert cd0 == len(np.unique(ev_value[sel]))
    med0 = int(widen(plane(qres.quantiles[0, 0])))
    sv = np.sort(ev_value[sel])
    assert med0 == sv[(len(sv) + 1) // 2 - 1]
    say("distinct", f"COUNT(DISTINCT value) + exact p50/p99 per sensor "
                    f"({ncd} sensors; both verified vs numpy on sensor "
                    f"{klo0})", sensors=ncd,
        count_distinct=cd.aggs["count_distinct"][:ncd].cpu().numpy(),
        quantiles=qres.quantiles[:, :ncd].view(torch.int32).cpu().numpy()
        .view(np.uint32))

    # --- 12. set algebra: sensors active in BOTH halves of the stream ----
    half = ev.num_rows // 2
    first = Table({"key": U64(ev["sensor"].lo[:half],
                              ev["sensor"].hi[:half])})
    second = Table({"key": U64(ev["sensor"].lo[half:],
                               ev["sensor"].hi[half:])})
    ikeys, ica, icb, inum = first.set_op(second, "intersect")
    inum = int(inum)
    assert inum == len(set(ev_sensor[:half].tolist())
                       & set(ev_sensor[half:].tolist()))
    say("set_op", f"{inum} sensors active in both stream halves "
                  "(INTERSECT, verified vs python sets)", both=inum,
        keys=ikeys.to_numpy()[:inum])

    # --- 13. SQL: the declarative front door, in core and over a mesh ----
    from tpu_qe_torch.sql import Database
    db = Database(dev)
    db.register("events", Table({
        "sensor": from_plane(ev["sensor"].lo, torch.uint32),
        "value": ev["value"]}))
    rows = db.sql(SQL)
    assert len(rows["sensor"]) <= 5 and (rows["c"] > 2).all()
    dist = db.sql(SQL, mesh=make_mesh(8, device=dev))
    assert all(np.array_equal(rows[c], dist[c]) for c in rows)
    say("sql", f"WHERE + GROUP BY + MEDIAN + HAVING + ORDER BY LIMIT -> "
               f"top {len(rows['sensor'])} sensors by filtered gain sum; "
               "the same rows over mesh= (8 shards)", rows=rows,
        mesh_rows=dist)

    # --- 14. SQL out-of-core: a virtual table bigger than one run --------
    from tpu_qe_torch.hashing import murmur_fmix32
    nbig = (1 << 16) + 17
    db.register_virtual("big", nbig, {
        "k": lambda i: from_plane(murmur_fmix32(i) & 255, torch.uint32),
        "v": lambda i: from_plane(i, torch.uint32)})
    brows = db.sql("SELECT k, COUNT(*) AS c, SUM(v) AS s FROM big "
                   "GROUP BY k", run_size=1 << 14)
    assert int(brows["c"].sum()) == nbig
    assert int(brows["s"].astype(np.uint64).sum()) == nbig * (nbig - 1) // 2
    say("bigsql", f"out-of-core SQL GROUP BY over a {nbig}-row virtual "
                  f"table ({len(brows['k'])} groups; closed-form verified)",
        rows=brows)
    print("done.")
    return out


if __name__ == "__main__":
    main()
