"""Distributed out-of-core COUNT(DISTINCT value) GROUP BY key over a mesh of
shards: the port of tpu_qe/ops/dbigdistinct.py.

Dedup is the compression at every level:

  phase A   per shard, per run: generate the run's (key, value) pairs
            (all local shards' indices in one launch sequence), sort them
            and compact the distinct pairs with exact occurrence counts
            (at most min(run_size, G * V) rows);
  phase L   per shard: one merge of its R partial tables, cross-run
            duplicates collapsing in the pair sort and their occurrence
            counts summing (at most min(n_local, G * V) rows);
  phase R   route the deduped pairs by key splitters (every key's pairs
            meet on one shard, so its count is local and exact) with the
            two-tier exchange (exchange/shuffle.py), then per shard one
            more dedup (copies of a pair from several sources collapse,
            their occurrences sum), the per-key distinct and row counts,
            and the data model's closed form checked on the device.

Every overflow (a run's table, a shard's table, the exchange's capacity)
is detected from exact counts. The data model is bigdistinct's: key = idx
mod G, value = (idx div G) mod V.

Every sort is ``sort_planes`` (B1-B3 on the card) and stable; the
reference's are unstable, and none of its ties can change the answer:
its (key, value) sorts tie only on rows equal in both key planes, whose
occurrence counts are summed afterwards (a sum does not depend on the
order), and its packed-position sorts are compactions, which
``stable_partition`` computes without a sort.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_qe_torch.bits import narrow, widen
from tpu_qe_torch.exchange.shuffle import (ONES, exchange,
                                           route_by_splitters,
                                           sample_splitters)
from tpu_qe_torch.ops.aggregate import _ends, _shift_right_one
from tpu_qe_torch.ops.bigagg import _ONES
from tpu_qe_torch.ops.bigdistinct import _bits, rows_of_index
from tpu_qe_torch.ops.filter import stable_partition
from tpu_qe_torch.sort.bigsort import _build_seconds, _fence
from tpu_qe_torch.sort.dbigsort import run_index
from tpu_qe_torch.sort.planes import sort_planes
from tpu_qe_torch.utils.profiling import span


def cap128(x: int, hard: int) -> int:
    """min(x, hard) rounded up to a multiple of 128, at most hard."""
    return min(-(-min(x, hard) // 128) * 128, hard)


def _dedup_sorted(sg, sv, occ_in=None):
    """Boundary dedup of a (key, value)-sorted pair stream whose pads (key
    all ones) sit at the tail; occurrence counts sum within each pair run
    (occ_in None: each row counts 1; pads carry occ 0).

    Returns (klo, v, occ, m) with the m distinct pairs compacted to the
    front (all ones / 0 behind); m is a 0-d int64 tensor."""
    n = sg.shape[0]
    pos = torch.arange(n, device=sg.device)
    sent = sg == _ONES
    pair_new = (((pos == 0) | (sg != _shift_right_one(sg, 0))
                 | (sv != _shift_right_one(sv, 0))) & ~sent)
    m = pair_new.sum()
    occ = (~sent).to(torch.int64) if occ_in is None else widen(occ_in)
    cum_occ = torch.cumsum(occ, 0)          # < 2^32 rows in all
    pair_end = ~sent & _ends(pair_new | sent)
    # the pair-end rows to the front, in order: the reference's sort of
    # packed positions, a compaction
    order = stable_partition(pair_end)
    ce = cum_occ[order]
    valid = pos < m
    return (torch.where(valid, sg[order], _ONES),
            torch.where(valid, sv[order], 0),
            torch.where(valid, narrow(ce - _shift_right_one(ce, 0)), 0), m)


def _dedup_runs(mesh, n_local, rr, run_size, n_groups, n_values,
                partial_cap):
    """Phase A: run rr of every local shard -> (S, partial_cap) planes
    (key, value, occurrences) and the (S,) exact distinct-pair counts."""
    idx = run_index(mesh, n_local, rr, run_size, mesh.device)
    g, v = rows_of_index(idx, n_groups, n_values)
    out = []
    for i in range(idx.shape[0]):
        sg, sv = sort_planes([g[i], v[i]], 2, key_bits=[_bits(n_groups),
                                                        _bits(n_values)])
        klo, val, occ, m = _dedup_sorted(sg, sv)
        out.append((klo[:partial_cap], val[:partial_cap],
                    occ[:partial_cap], m))
    return tuple(torch.stack(c) for c in zip(*out))


def _local_combine(klo, v, occ, local_cap, n_values):
    """Phase L for one shard: its R tables concatenated, merged into one
    deduped pair table cut to local_cap rows; (klo, v, occ, m)."""
    sg, sv, so = sort_planes([klo, v, occ], 2,
                             key_bits=[32, _bits(n_values)])
    dk, dv, do, m = _dedup_sorted(sg, sv, occ_in=so)
    return dk[:local_cap], dv[:local_cap], do[:local_cap], m


def _route_count(mesh, klo, v, occ, m_loc, *, samples_per_dev, capacity,
                 n, n_groups, n_values, collect):
    """Phase R: route the pairs by key splitters, count distinct values
    and rows per key on each shard, verify the closed form. Returns the
    (S, 4) int64 checks (cd_ok, cnt_ok, keys_ok, num_groups), the psum of
    num_groups, the overflow flags, the (S,) pairs each shard received and
    (collect) the per-shard table planes."""
    n_dev = mesh.n_dev
    shards, width = klo.shape
    dev = klo.device
    is_real = torch.arange(width, device=dev)[None] < m_loc[:, None]
    kl = torch.where(is_real, klo, _ONES)
    kh = torch.where(is_real, 0, _ONES).to(torch.int32)
    sp_lo, sp_hi = sample_splitters(mesh, kl, kh, n_dev, samples_per_dev,
                                    n_valid=m_loc)
    dest = route_by_splitters(kl, kh, sp_lo, sp_hi)
    dest = torch.where(is_real, dest,
                       mesh.ranks()[:, None].to(torch.int32))
    recv, _, _, recv_counts, ovf_x = exchange(
        mesh, dest, [kl, torch.where(is_real, v, 0),
                     torch.where(is_real, occ, 0)],
        [ONES, 0, 0], n_dev, capacity)
    del dest, kl, kh
    checks, tables = [], []
    for s in range(shards):
        sg, sv, so = sort_planes([c[s] for c in recv], 2,
                                 key_bits=[32, _bits(n_values)])
        # copies of a pair from several sources collapse; occurrences sum
        mm = sg.shape[0]
        pos = torch.arange(mm, device=dev)
        sent = sg == _ONES
        key_new = ((pos == 0) | (sg != _shift_right_one(sg, 0))) & ~sent
        pair_new = (key_new | (sv != _shift_right_one(sv, 0))) & ~sent
        key_end = ~sent & _ends(key_new | sent)
        num_groups = key_end.sum()
        cum_nd = torch.cumsum(pair_new.to(torch.int64), 0)
        cum_occ = torch.cumsum(widen(so), 0)
        order = stable_partition(key_end)
        gkey = widen(sg[order])
        cd_end, cnt_end = cum_nd[order], cum_occ[order]
        gcd = cd_end - _shift_right_one(cd_end, 0)
        gcnt = cnt_end - _shift_right_one(cnt_end, 0)
        gvalid = pos < num_groups
        want_cnt = n // n_groups + (gkey < n % n_groups).to(torch.int64)
        want_cd = torch.clamp(want_cnt, max=n_values)
        checks.append(torch.stack([
            (~gvalid | (gcd == want_cd)).all(),
            (~gvalid | (gcnt == want_cnt)).all(),
            (~gvalid[1:] | (gkey[1:] > gkey[:-1])).all()]).to(torch.int64))
        checks[-1] = torch.cat([checks[-1], num_groups.view(1)])
        if collect:
            tables.append((torch.where(gvalid, narrow(gkey), _ONES),
                           torch.where(gvalid, narrow(gcd), 0),
                           torch.where(gvalid, narrow(gcnt), 0)))
    checks = torch.stack(checks)                            # (S, 4)
    g_total = mesh.psum(checks[:, 3])
    # the pads stay on their own shard: the rest are the real pairs
    pairs = recv_counts.sum(1) - (width - m_loc)
    return checks, g_total, ovf_x, pairs, tables


@dataclasses.dataclass
class DistBigDistinctResult:
    n: int
    n_groups: int
    n_values: int
    n_dev: int
    n_runs: int                  # per device
    num_groups: int
    groups_ok: bool
    cd_ok: bool
    cnt_ok: bool
    keys_ok: bool
    overflow: bool
    seconds: float
    dedup_s: float
    combine_s: float
    route_s: float
    rows_per_s: float
    table: dict | None = None

    @property
    def all_ok(self) -> bool:
        return (self.groups_ok and self.cd_ok and self.cnt_ok
                and self.keys_ok and not self.overflow
                and self.num_groups == min(self.n_groups, self.n))


def count_distinct_big_distributed(n: int, mesh, n_groups: int = 1 << 16,
                                   n_values: int = 1 << 8,
                                   run_size: int = 1 << 26,
                                   samples_per_dev: int = 128,
                                   capacity_factor: float = 2.0,
                                   collect: bool = False,
                                   verbose: bool = False,
                                   force_composed: bool = False,
                                   stats: dict | None = None
                                   ) -> DistBigDistinctResult:
    """COUNT(DISTINCT value) GROUP BY key over n rows sharded as
    out-of-core runs across the mesh (module docstring), on the mesh's
    device. At D == 1 the call delegates to count_distinct_big unless
    force_composed. stats (a dict) receives "shard_pairs", the deduped
    pairs each shard received in the route (composed path only)."""
    n_dev = mesh.n_dev
    dev = mesh.device
    if n_dev == 1 and not force_composed:
        from tpu_qe_torch.ops.bigdistinct import count_distinct_big
        r = count_distinct_big(n, n_groups=n_groups, n_values=n_values,
                               run_size=run_size, collect=collect,
                               verbose=verbose, device=dev)
        return DistBigDistinctResult(
            n=n, n_groups=n_groups, n_values=n_values, n_dev=1,
            n_runs=r.n_runs, num_groups=r.num_groups,
            groups_ok=r.groups_ok, cd_ok=r.cd_ok, cnt_ok=r.cnt_ok,
            keys_ok=r.keys_ok, overflow=r.overflow, seconds=r.seconds,
            dedup_s=r.dedup_s, combine_s=0.0, route_s=r.combine_s,
            rows_per_s=r.rows_per_s, table=r.table)
    assert n % (n_dev * run_size) == 0, \
        (f"n must be a multiple of devices*run_size "
         f"(n={n}, devices={n_dev}, run_size={run_size})")
    assert n < (1 << 32) and n_groups < (1 << 32) - 1
    n_local = n // n_dev
    n_runs = n_local // run_size
    pairs_bound = n_groups * n_values
    partial_cap = cap128(pairs_bound, run_size)
    local_cap = cap128(pairs_bound, n_local)
    capacity = max(int(np.ceil(capacity_factor * local_cap / n_dev)), 16)
    _build_seconds(dev)             # the kernels' build stays untimed

    t0 = _fence(dev)
    with span("dbigdistinct phase A: run dedup"):
        parts = [_dedup_runs(mesh, n_local, rr, run_size, n_groups,
                             n_values, partial_cap) for rr in range(n_runs)]
        m_run = torch.stack([p[3] for p in parts])
        m_run_host = mesh.collect(m_run.T.contiguous()).cpu().numpy()
    ovf_run = bool((m_run_host > partial_cap).any())
    t1 = _fence(dev)
    with span("dbigdistinct phase L: local merge"):
        cols = [torch.cat([p[c] for p in parts], 1) for c in range(3)]
        del parts
        loc = [_local_combine(cols[0][i], cols[1][i], cols[2][i], local_cap,
                              n_values) for i in range(cols[0].shape[0])]
        del cols
        dk, dv, do, m_loc = (torch.stack(c) for c in zip(*loc))
        del loc
        m_loc_host = mesh.collect(m_loc).cpu().numpy()
    ovf_l = bool((m_loc_host > local_cap).any())
    t2 = _fence(dev)
    with span("dbigdistinct phase R: route + count"):
        checks, g_total, ovf_x, pairs, tables = _route_count(
            mesh, dk, dv, do, m_loc, samples_per_dev=samples_per_dev,
            capacity=capacity, n=n, n_groups=n_groups, n_values=n_values,
            collect=collect)
        del dk, dv, do
        out = mesh.collect(torch.cat([checks, g_total[:, None],
                                      ovf_x[:, None], pairs[:, None]],
                                     1)).cpu().numpy()
    t3 = _fence(dev)
    cd_ok, cnt_ok, keys_ok, ngs, g_tot, ovf, pairs = out.T
    if verbose:
        print(f"dbigdistinct: D={n_dev} R={n_runs} caps "
              f"{partial_cap}/{local_cap}/{capacity}; pairs/run max "
              f"{m_run_host.max()}, per-dev {m_loc_host.max()}; "
              f"A={t1 - t0:.2f}s L={t2 - t1:.2f}s R={t3 - t2:.2f}s")
    if stats is not None:
        stats["shard_pairs"] = [int(x) for x in pairs]
    table = None
    if collect:
        width = max(t[0].shape[0] for t in tables)
        planes = [mesh.collect(torch.stack([c[:width] for c in col]))
                  .cpu().numpy().view(np.uint32) for col in zip(*tables)]
        gk, gcd, gcnt = ([p[d, :int(ngs[d])] for d in range(n_dev)]
                         for p in planes)
        table = {"key": np.concatenate(gk),
                 "count_distinct": np.concatenate(gcd),
                 "count": np.concatenate(gcnt)}
    secs = t3 - t0
    return DistBigDistinctResult(
        n=n, n_groups=n_groups, n_values=n_values, n_dev=n_dev,
        n_runs=n_runs, num_groups=int(g_tot.max()),
        groups_ok=bool(g_tot.max() == min(n_groups, n)),
        cd_ok=bool(cd_ok.all()), cnt_ok=bool(cnt_ok.all()),
        keys_ok=bool(keys_ok.all()),
        overflow=ovf_run or ovf_l or bool(ovf.any()),
        seconds=secs, dedup_s=t1 - t0, combine_s=t2 - t1,
        route_s=t3 - t2, rows_per_s=n / secs, table=table)
