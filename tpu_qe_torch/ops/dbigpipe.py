"""Distributed out-of-core fused join -> GROUP BY over a mesh of shards: the
port of tpu_qe/ops/dbigpipe.py.

Both join sides exceed the mesh's memory and the joined stream never
exists anywhere:

  phases A/B/X   ops/dbigjoin.py as it is (sorted runs of both sides per
                 shard, union splitters, the segment exchange);
  phase C        each bucket's join also partially aggregates the joined
                 values (join_big_distributed's aggregate_groups): only
                 the G-bounded padded partial table leaves the bucket;
  phase D        ops/dbigagg.py's combine as it is: per shard, merge its
                 B bucket tables, all_gather the local tables, one global
                 merge with exact u64 sums and the checks on the device.

The group-count total must equal the join's match count, which must equal
(n_l + 1) // 2 (bigjoin's construction: matches are exactly the even left
indices); per-group sums are held to numpy in the tests.
"""

from __future__ import annotations

import dataclasses

from tpu_qe_torch.ops.bigagg import _host_table
from tpu_qe_torch.ops.dbigagg import combine_tables
from tpu_qe_torch.ops.dbigjoin import join_big_distributed
from tpu_qe_torch.sort.bigsort import _fence
from tpu_qe_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class DBigPipeResult:
    n_l: int
    n_r: int
    n_dev: int
    matched: int
    n_groups: int
    seconds: float
    rows_per_s: float
    join_ok: bool
    count_ok: bool
    keys_ok: bool
    compile_s: float

    @property
    def all_ok(self) -> bool:
        return self.join_ok and self.count_ok and self.keys_ok


def join_aggregate_big_distributed(n_l: int, n_r: int, mesh,
                                   n_groups: int = 1 << 16,
                                   run_size: int = 1 << 26,
                                   buckets_per_dev: int | None = None,
                                   seed: int = 7, verbose: bool = False,
                                   collect: bool = False,
                                   force_composed: bool = False,
                                   stats: dict | None = None):
    """Fused distributed out-of-core FK join -> GROUP BY (module
    docstring), on the mesh's device. Both sides multiples of D *
    run_size. At D == 1 the call delegates to join_aggregate_big unless
    force_composed. collect=True also returns the host group table dict
    (key, count, sum). stats: as join_big_distributed's."""
    n_dev = mesh.n_dev
    dev = mesh.device
    if n_dev == 1 and not force_composed:
        from tpu_qe_torch.ops.bigpipe import join_aggregate_big
        return join_aggregate_big(n_l, n_r, n_groups=n_groups,
                                  n_buckets=buckets_per_dev, seed=seed,
                                  verbose=verbose, collect=collect,
                                  device=dev)

    jres, partials = join_big_distributed(
        n_l, n_r, mesh, run_size=run_size, buckets_per_dev=buckets_per_dev,
        seed=seed, verbose=verbose, force_composed=force_composed,
        aggregate_groups=n_groups, stats=stats)

    n_b = len(partials)
    local_cap = min(n_groups, n_b * partials[0][0].shape[1])
    t1 = _fence(dev)
    with span("dbigpipe phase D: combine"):
        tables = [[tuple(c[i] for c in p) for p in partials]
                  for i in range(partials[0][0].shape[0])]
        del partials
        scal, planes = combine_tables(mesh, tables, local_cap, False,
                                      collect)
    t_d = _fence(dev) - t1
    ng, total_cnt, _, _, ks, _ = scal
    dt = jres.seconds + t_d
    res = DBigPipeResult(
        n_l=n_l, n_r=n_r, n_dev=n_dev, matched=jres.matched, n_groups=ng,
        seconds=dt, rows_per_s=n_l / dt, join_ok=jres.all_ok,
        count_ok=(total_cnt == jres.matched == (n_l + 1) // 2),
        keys_ok=bool(ks), compile_s=jres.compile_s)
    if verbose:
        print(f"dbigpipe: {n_l}x{n_r} -> {jres.matched} matches -> "
              f"{ng} groups in {dt:.2f}s ok={res.all_ok}")
    if collect:
        return res, _host_table(planes, minmax=False)
    return res
