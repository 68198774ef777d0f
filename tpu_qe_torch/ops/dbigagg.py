"""Distributed out-of-core GROUP BY over a mesh of shards: the port of
tpu_qe/ops/dbigagg.py.

A two-level combine tree in which every level is the same verified merge
(ops/bigagg.py::_merge_partials):

  phase A   every shard partial-aggregates its run r (global row index
            d * n_local + r * run_size + lane, regenerable; all local
            shards' indices made in one launch sequence); only the padded
            partial group tables survive each run;
  phase B   each shard merges its R partial tables (groups collapse to at
            most min(G, n_local) rows), cuts the merged table to
            local_cap rows (pads with the merge's identities), all_gathers
            the D local tables (the only cross-shard traffic) and merges
            and verifies the global table with bigagg's closed forms
            (count total n, u64 value total n(n-1)/2, strictly ascending
            keys, min / max bounds).

The global merge is work the JAX package repeats on every device after
its all_gather. On a LocalMesh every shard sees the same gathered table,
so the port merges it once; on a GroupMesh every rank merges its own
copy. Every sort is ``sort_planes`` (B1-B3 on the card); the merge's key
sort is stable where the reference's is not, and its answer does not
depend on the order of tied rows (equal keys fold into one group).

checkpoint_dir: the per-run tables are the checkpoint, in bigagg's
format: run r's (D * partial_cap,) planes of every shard, named
`bigagg_rund{r}.npz`, meta [n, D, G, run_size, seed, minmax], so a
checkpoint written by either package resumes in the other. On a
GroupMesh rank 0 writes.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_qe_torch.bits import narrow
from tpu_qe_torch.exchange.mesh import GroupMesh
from tpu_qe_torch.ops.bigagg import (_ONES, BigAggResult, _aggregate_rows,
                                     _host_table, _merge_partials,
                                     _verify_and_emit)
from tpu_qe_torch.sort.bigsort import _build_seconds, _fence
from tpu_qe_torch.sort.dbigsort import run_index
from tpu_qe_torch.utils.profiling import span

# the merged planes' identities: key all ones, count and sums 0, min all
# ones, max 0 (klo, khi, cnt, slo, shi[, min, max])
_IDENTS = (_ONES, _ONES, 0, 0, 0, _ONES, 0)


def _runs(mesh, n_local, r, run_size, n_groups, seed, partial_cap, minmax):
    """Phase A: run r of every local shard -> its padded partial table as
    (S, partial_cap) int32 planes."""
    idx = run_index(mesh, n_local, r, run_size, mesh.device)
    parts = [_aggregate_rows(idx[i], n_groups, seed, partial_cap, minmax)
             for i in range(idx.shape[0])]
    return tuple(torch.stack(c) for c in zip(*parts))


def _fit(x: torch.Tensor, cap: int, fill: int) -> torch.Tensor:
    """The first cap rows of a 1-D plane, `fill` past its end."""
    if x.shape[0] >= cap:
        return x[:cap]
    return torch.cat([x, x.new_full((cap - x.shape[0],), fill)])


def _local_tables(tables, local_cap: int, minmax: bool):
    """One shard's merged table cut to local_cap rows: the valid groups
    compacted to the front, the merge's identities behind. tables: that
    shard's (klo, khi, cnt, slo, shi[, min, max]) 1-D planes per table."""
    ncols = len(tables[0])
    cols = tuple(torch.cat([t[c] for t in tables]) for c in range(ncols))
    gklo, gkhi, gcnt, gsums, gmn, gmx, gvalid = _merge_partials(cols)
    planes = [gklo, gkhi, narrow(gcnt), gsums[0].lo, gsums[0].hi] \
        + ([gmn, gmx] if minmax else [])
    return [_fit(torch.where(gvalid, a, _IDENTS[c]), local_cap, _IDENTS[c])
            for c, a in enumerate(planes)]


def combine_tables(mesh, tables, local_cap: int, minmax: bool,
                   collect: bool):
    """Phase B over every local shard's partial tables (tables[i]: shard
    i's list of tables): local merge, all_gather, one global merge and
    verification. Returns bigagg's (scalars, planes)."""
    loc = [_local_tables(t, local_cap, minmax) for t in tables]
    stacked = [torch.stack(c) for c in zip(*loc)]       # (S, local_cap)
    del loc
    # every shard's gathered copy is the same table: merge it once
    gathered = tuple(mesh.all_gather(a)[0] for a in stacked)
    del stacked
    return _verify_and_emit(_merge_partials(gathered), collect, minmax)


def aggregate_big_distributed(n: int, mesh, n_groups: int = 1 << 20,
                              run_size: int = 1 << 26, seed: int = 7,
                              verbose: bool = False, collect: bool = False,
                              minmax: bool = False,
                              force_composed: bool = False,
                              checkpoint_dir: str | None = None):
    """Distributed out-of-core GROUP BY of n generated rows over `mesh`
    (module docstring), on the mesh's device.

    n must be a multiple of D * run_size (D = mesh.n_dev). The row model
    is aggregate_big's (group = hash(global index) mod n_groups, value =
    the index), so the table equals the single-device one at equal n. At
    D == 1 the call delegates to aggregate_big unless force_composed.
    Returns BigAggResult; with collect=True also the host group table
    dict (key, count, sum[, min, max]).
    """
    n_dev = mesh.n_dev
    dev = mesh.device
    if n_dev == 1 and not force_composed:
        from tpu_qe_torch.ops.bigagg import aggregate_big
        return aggregate_big(n, n_groups=n_groups, run_size=run_size,
                             seed=seed, verbose=verbose, collect=collect,
                             minmax=minmax, checkpoint_dir=checkpoint_dir,
                             device=dev)
    assert n % (n_dev * run_size) == 0, \
        (f"n must be a multiple of devices*run_size "
         f"(n={n}, devices={n_dev}, run_size={run_size})")
    assert n < (1 << 32), "values travel as u32 global index"
    n_local = n // n_dev
    n_runs = n_local // run_size
    partial_cap = min(n_groups, run_size)
    local_cap = min(n_groups, n_runs * partial_cap)
    assert n_dev * local_cap < (1 << 28), \
        ("replicated combine exceeds the in-core cap; a key-ranged "
         "exchange combine is required at this G (module docstring)",
         n_dev, local_cap)
    compile_s = _build_seconds(dev)
    ranks = mesh.ranks().tolist()
    writer = not isinstance(mesh, GroupMesh) or mesh.rank == 0

    t0 = _fence(dev)
    parts, resumed = [], 0
    with span("dbigagg phase A: partial runs"):
        if checkpoint_dir is None:
            parts = [_runs(mesh, n_local, r, run_size, n_groups, seed,
                           partial_cap, minmax) for r in range(n_runs)]
        else:
            # the per-run tables are the checkpoint (aggregate_big's
            # contract); each run's shards go to the host as one table
            from tpu_qe_torch.ops.bigagg import _run_ck_load, _run_ck_save
            meta = np.asarray([n, n_dev, n_groups, run_size, seed,
                               int(minmax)], np.int64)
            for r in range(n_runs):
                part = _run_ck_load(checkpoint_dir, f"d{r}", meta, dev)
                if part is not None:
                    part = tuple(a.reshape(n_dev, -1)[ranks] for a in part)
                    resumed += 1
                else:
                    part = _runs(mesh, n_local, r, run_size, n_groups, seed,
                                 partial_cap, minmax)
                    whole = [mesh.collect(a).reshape(-1) for a in part]
                    if writer:
                        _run_ck_save(checkpoint_dir, f"d{r}", meta, whole)
                    del whole
                parts.append(part)
            mesh.barrier()      # rank 0's tables are on the disk
            if verbose and resumed:
                print(f"dbigagg: resuming — {resumed}/{n_runs} round tables "
                      "loaded from checkpoint")
    t_a = _fence(dev) - t0

    t1 = _fence(dev)
    with span("dbigagg phase B: combine"):
        tables = [[tuple(c[i] for c in p) for p in parts]
                  for i in range(len(ranks))]
        del parts
        scal, planes = combine_tables(mesh, tables, local_cap, minmax,
                                      collect)
        del tables
    t_b = _fence(dev) - t1
    ng, total_cnt, tlo, thi, ks, mm = scal
    dt = t_a + t_b
    res = BigAggResult(
        n=n, n_groups=ng, seconds=dt, rows_per_s=n / dt,
        count_ok=(total_cnt == n),
        sum_ok=((thi << 32) | tlo) == n * (n - 1) // 2,
        keys_ok=bool(ks), groups_ok=(ng <= min(n_groups, n)),
        phase_a_s=t_a, phase_b_s=t_b, compile_s=compile_s,
        minmax_ok=bool(mm))
    if verbose:
        print(f"dbigagg: n={n} D={n_dev} R={n_runs}/dev G={n_groups} "
              f"local_cap={local_cap} groups={ng} "
              f"A={t_a:.2f}s B={t_b:.2f}s ok={res.all_ok}")
    if collect:
        return res, _host_table(planes, minmax)
    return res
