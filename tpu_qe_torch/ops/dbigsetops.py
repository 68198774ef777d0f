"""Distributed out-of-core set operations (UNION / INTERSECT / EXCEPT,
DISTINCT semantics) over a mesh of shards: the port of
tpu_qe/ops/dbigsetops.py.

Dedup is the compression at every level, as in ops/dbigdistinct.py, with
the side flag in the value plane of its pair machinery:

  phase A   per shard, per run, per side: generate the run's keys (all
            local shards' indices in one launch sequence), sort, and
            compact the distinct keys with exact occurrence counts;
  phase L   per shard: one merge of the partial tables of both sides into
            a distinct (key, side) pair table, occurrences summing;
  phase R   route the pairs by key splitters (every key's verdict is then
            local and exact) with the two-tier exchange; per shard, each
            key's side multiplicities from two cumulative sums (copies of
            a pair from several sources just add up), the op's predicate,
            the qualifying keys compacted with their multiplicities, the
            closed forms checked per key, and a psum of the qualifying
            counts.

The splitter ranges are disjoint and ascending over the shards, so the
shards' results in rank order are the global result. Every overflow is
detected from exact counts. The data model is bigsetops': side A keys =
idx mod g_a, side B keys = idx mod g_b + offset, and max(g_a, offset +
g_b) < 2^32 - 1 keeps every real key below the all-ones pad.

Every sort is ``sort_planes`` (B1-B3 on the card) and stable. None of the
reference's unstable sorts has ties that reach the answer: its run sorts
tie only on equal keys, its (key, side) merge only on equal pairs whose
occurrences are summed, its route sort (by key alone) on rows of one key,
whose side multiplicities are sums over the key's rows; its packed
sorts are compactions (``stable_partition``).
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
from tpu_qe_torch.ops.bigdistinct import _bits
from tpu_qe_torch.ops.bigsetops import (expected_result_numpy,
                                        keys_of_index, set_op_big)
from tpu_qe_torch.ops.dbigdistinct import _dedup_sorted, cap128
from tpu_qe_torch.ops.filter import stable_partition
from tpu_qe_torch.ops.setops import _OPS, _qualifies
from tpu_qe_torch.sort.bigsort import _build_seconds, _fence
from tpu_qe_torch.sort.dbigsort import run_index
from tpu_qe_torch.sort.planes import sort_planes
from tpu_qe_torch.utils.profiling import span


def _dedup_runs(mesh, n_local, rr, run_size, n_groups, offset, partial_cap):
    """Phase A: one side's run rr on every local shard -> (S, partial_cap)
    planes (key, occurrences) and the (S,) exact distinct-key counts."""
    idx = run_index(mesh, n_local, rr, run_size, mesh.device)
    keys = keys_of_index(idx, n_groups, offset)
    out = []
    for i in range(idx.shape[0]):
        (sk,) = sort_planes([keys[i]], 1, key_bits=[_bits(offset
                                                          + n_groups)])
        klo, _, occ, m = _dedup_sorted(sk, torch.zeros_like(sk))
        out.append((klo[:partial_cap], occ[:partial_cap], m))
    return tuple(torch.stack(c) for c in zip(*out))


def _route_qualify(mesh, klo, side, occ, m_loc, *, op, samples_per_dev,
                   capacity, n_a, g_a, n_b, g_b, offset, collect):
    """Phase R: route the (key, side) pairs by key splitters, derive each
    key's (count_a, count_b), qualify and verify. Returns the (S, 3) int64
    checks (counts_ok, keys_ok, num), the psum of num, the overflow
    flags, the (S,) pairs each shard received and (collect) the per-shard
    result planes."""
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
        mesh, dest, [kl, torch.where(is_real, side, 0),
                     torch.where(is_real, occ, 0)],
        [ONES, 0, 0], n_dev, capacity)
    del dest, kl, kh
    checks, tables = [], []
    for s in range(shards):
        sk, ss, so = sort_planes([c[s] for c in recv], 1)
        mm = sk.shape[0]
        pos = torch.arange(mm, device=dev)
        sent = sk == _ONES
        key_new = ((pos == 0) | (sk != _shift_right_one(sk, 0))) & ~sent
        key_end = ~sent & _ends(key_new | sent)
        n_keys = key_end.sum()
        so = widen(so)
        cum_b = torch.cumsum(so * widen(ss), 0)
        cum_tot = torch.cumsum(so, 0)
        order = stable_partition(key_end)
        gkey = widen(sk[order])
        b_end, t_end = cum_b[order], cum_tot[order]
        cb = b_end - _shift_right_one(b_end, 0)
        ca = t_end - _shift_right_one(t_end, 0) - cb
        gvalid = pos < n_keys
        want_ca = torch.where(
            gkey < g_a, n_a // g_a + (gkey < n_a % g_a).to(torch.int64), 0)
        kb = gkey - offset
        in_b = (gkey >= offset) & (kb < g_b)
        want_cb = torch.where(
            in_b, n_b // g_b + (kb < n_b % g_b).to(torch.int64), 0)
        keep = gvalid & _qualifies(op, ca > 0, cb > 0)
        num = keep.sum()
        checks.append(torch.stack([
            (~gvalid | ((ca == want_ca) & (cb == want_cb))).all(),
            (~gvalid[1:] | (gkey[1:] > gkey[:-1])).all(), num]).to(
            torch.int64))
        if collect:
            order2 = stable_partition(keep)
            rvalid = pos < num
            tables.append((torch.where(rvalid, narrow(gkey[order2]), _ONES),
                           torch.where(rvalid, narrow(ca[order2]), 0),
                           torch.where(rvalid, narrow(cb[order2]), 0)))
    checks = torch.stack(checks)                            # (S, 3)
    # the pads stay on their own shard: the rest are the real pairs
    pairs = recv_counts.sum(1) - (width - m_loc)
    return checks, mesh.psum(checks[:, 2]), ovf_x, pairs, tables


@dataclasses.dataclass
class DistBigSetOpResult:
    op: str
    n_a: int
    n_b: int
    g_a: int
    g_b: int
    offset: int
    n_dev: int
    n_runs_a: int                # per device
    n_runs_b: int
    num: int
    expected_num: int
    counts_ok: bool
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
        return (self.counts_ok and self.keys_ok and not self.overflow
                and self.num == self.expected_num)


def set_op_big_distributed(op: str, n_a: int, n_b: int, mesh,
                           g_a: int = 1 << 16, g_b: int = 1 << 16,
                           offset: int = 1 << 15,
                           run_size: int = 1 << 26,
                           samples_per_dev: int = 128,
                           capacity_factor: float = 2.0,
                           collect: bool = False, verbose: bool = False,
                           force_composed: bool = False,
                           stats: dict | None = None
                           ) -> DistBigSetOpResult:
    """DISTINCT-semantics set operation over two key bags sharded as
    out-of-core runs across the mesh (module docstring), on the mesh's
    device. At D == 1 the call delegates to set_op_big unless
    force_composed. stats (a dict) receives "shard_pairs", the (key,
    side) pairs each shard received in the route (composed path only)."""
    if op not in _OPS:
        raise ValueError(f"op must be one of {_OPS}, got {op!r}")
    n_dev = mesh.n_dev
    dev = mesh.device
    if n_dev == 1 and not force_composed:
        r = set_op_big(op, n_a, n_b, g_a=g_a, g_b=g_b, offset=offset,
                       run_size=run_size, collect=collect,
                       verbose=verbose, device=dev)
        return DistBigSetOpResult(
            op=op, n_a=n_a, n_b=n_b, g_a=g_a, g_b=g_b, offset=offset,
            n_dev=1, n_runs_a=r.n_runs_a, n_runs_b=r.n_runs_b,
            num=r.num, expected_num=r.expected_num,
            counts_ok=r.counts_ok, keys_ok=r.keys_ok,
            overflow=r.overflow, seconds=r.seconds, dedup_s=r.dedup_s,
            combine_s=0.0, route_s=r.combine_s,
            rows_per_s=r.rows_per_s, table=r.table)
    for n, nm in ((n_a, "n_a"), (n_b, "n_b")):
        assert n % (n_dev * run_size) == 0, \
            (f"{nm} must be a multiple of devices*run_size "
             f"({nm}={n}, devices={n_dev}, run_size={run_size})")
    assert n_a + n_b < (1 << 32)
    # keeps every real key below the all-ones pad of the exchange
    assert max(g_a, offset + g_b) < (1 << 32) - 1
    nla, nlb = n_a // n_dev, n_b // n_dev
    runs_a, runs_b = nla // run_size, nlb // run_size
    cap_a = cap128(g_a, run_size)
    cap_b = cap128(g_b, run_size)
    local_cap = cap128(g_a + g_b, nla + nlb)
    capacity = max(int(np.ceil(capacity_factor * local_cap / n_dev)), 16)
    _build_seconds(dev)             # the kernels' build stays untimed

    t0 = _fence(dev)
    parts, m_runs, caps_of = [], [], []
    with span("dbigsetops phase A: run dedup"):
        for s, n_loc, runs, g, off, cap in ((0, nla, runs_a, g_a, 0, cap_a),
                                            (1, nlb, runs_b, g_b, offset,
                                             cap_b)):
            for rr in range(runs):
                klo, occ, m = _dedup_runs(mesh, n_loc, rr, run_size, g, off,
                                          cap)
                parts.append((klo, torch.full_like(klo, s), occ))
                m_runs.append(m)
                caps_of.append(cap)
        m_run_host = mesh.collect(torch.stack(m_runs, 1)).cpu().numpy()
    ovf_run = bool((m_run_host.max(axis=0) > np.array(caps_of)).any())
    t1 = _fence(dev)
    with span("dbigsetops phase L: local merge"):
        cols = [torch.cat([p[c] for p in parts], 1) for c in range(3)]
        del parts
        loc = []
        for i in range(cols[0].shape[0]):
            sk, ss, so = sort_planes([cols[0][i], cols[1][i], cols[2][i]],
                                     2, key_bits=[32, 1])
            dk, dsd, do, m = _dedup_sorted(sk, ss, occ_in=so)
            loc.append((dk[:local_cap], dsd[:local_cap], do[:local_cap], m))
        del cols
        dk, dsd, do, m_loc = (torch.stack(c) for c in zip(*loc))
        del loc
        ovf_l = bool((mesh.collect(m_loc).cpu().numpy() > local_cap).any())
    t2 = _fence(dev)
    with span("dbigsetops phase R: route + qualify"):
        checks, num_tot, ovf_x, pairs, tables = _route_qualify(
            mesh, dk, dsd, do, m_loc, op=op, samples_per_dev=samples_per_dev,
            capacity=capacity, n_a=n_a, g_a=g_a, n_b=n_b, g_b=g_b,
            offset=offset, collect=collect)
        del dk, dsd, do
        out = mesh.collect(torch.cat([checks, num_tot[:, None],
                                      ovf_x[:, None], pairs[:, None]],
                                     1)).cpu().numpy()
    t3 = _fence(dev)
    counts_ok, keys_ok, nums, num_t, ovf, pairs = out.T
    ek, _, _ = expected_result_numpy(op, n_a, g_a, n_b, g_b, offset)
    if verbose:
        print(f"dbigsetops[{op}]: D={n_dev} R={runs_a}+{runs_b} caps "
              f"{cap_a}/{cap_b}/{local_cap}/{capacity}; "
              f"A={t1 - t0:.2f}s L={t2 - t1:.2f}s R={t3 - t2:.2f}s")
    if stats is not None:
        stats["shard_pairs"] = [int(x) for x in pairs]
    table = None
    if collect:
        planes = [mesh.collect(torch.stack(col)).cpu().numpy().view(
            np.uint32) for col in zip(*tables)]
        gk, ca, cb = ([p[d, :int(nums[d])] for d in range(n_dev)]
                      for p in planes)
        table = {"key": np.concatenate(gk), "count_a": np.concatenate(ca),
                 "count_b": np.concatenate(cb)}
    secs = t3 - t0
    return DistBigSetOpResult(
        op=op, n_a=n_a, n_b=n_b, g_a=g_a, g_b=g_b, offset=offset,
        n_dev=n_dev, n_runs_a=runs_a, n_runs_b=runs_b,
        num=int(num_t.max()), expected_num=len(ek),
        counts_ok=bool(counts_ok.all()), keys_ok=bool(keys_ok.all()),
        overflow=ovf_run or ovf_l or bool(ovf.any()), seconds=secs,
        dedup_s=t1 - t0, combine_s=t2 - t1, route_s=t3 - t2,
        rows_per_s=(n_a + n_b) / secs, table=table)
