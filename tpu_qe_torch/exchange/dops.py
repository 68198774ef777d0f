"""Distributed query operators over a mesh of shards: the port of
tpu_qe/exchange/dops.py.

Each is one keyed shuffle (exchange/shuffle.py) and the port's local
operator on every shard (ops/join.py, ops/aggregate.py, ops/setops.py),
in the JAX package's SPMD style: shard bodies take the mesh and (S, n)
int32 planes of u32 bit patterns, and the local operator runs once per
local shard. Every result keeps the JAX per-shard padded layout; the
numpy wrappers take and return what the JAX wrappers do.

distributed_join_fk
    Route both sides with the same (key, position) splitters sampled from
    the union of both key distributions, so equal keys co-locate and hot
    left keys split across shards; right rows whose key straddles a
    splitter are broadcast to every shard. Then the local scan join with
    validity masks over the exchange padding. Results carry each left
    row's global index, so the wrapper restores the left order.
distributed_join_inner / distributed_join_outer
    Bare-key splitters (every copy of a key on one shard) and the padded
    one-to-many inner or LEFT / FULL outer join per shard.
distributed_top_k
    Local top-k per shard, all_gather of the k*D candidates, one more
    selection; ties by global row order.
distributed_aggregate
    Two-phase aggregation: local group_aggregate (the volume reducer),
    shuffle the partial groups by key, combine them per key. Padding
    slots carry neutral values (count / sum 0, min 0xFFFFFFFF, max 0) and
    a trailing count marks padding groups (count 0).
distributed_count_distinct, distributed_join_aggregate,
distributed_set_op
    Local dedup (or the fused stream join + sorted partial aggregate) as
    the volume reducer, then a shuffle by key and the local verdict.

One difference from the JAX package: distributed_set_op tells its pad
slots from a real all-ones key by their zero multiplicity, where the JAX
body reads every all-ones key as padding and drops it (ROADMAP Queue C).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_qe_torch.bits import U64, narrow, widen
from tpu_qe_torch.exchange.dsort import (_global_pos, collect_u32, shard_u32,
                                         shard_u64)
from tpu_qe_torch.exchange.shuffle import (ONES, exchange, i32,
                                           offdiag_demand, pow2_capacity,
                                           route_by_splitters,
                                           route_by_splitters_pos,
                                           sample_splitters,
                                           sample_splitters_pos)
from tpu_qe_torch.ops.aggregate import (_ends, _shift_right_one,
                                        group_aggregate,
                                        group_aggregate_sorted,
                                        segmented_reduce, segmented_sum_u64)
from tpu_qe_torch.ops.filter import stable_partition
from tpu_qe_torch.ops.join import (join_fk_scan, join_inner_padded,
                                   join_outer_padded)
from tpu_qe_torch.ops.setops import _OPS, _qualifies
from tpu_qe_torch.sort.planes import argsort_planes, sort_planes
from tpu_qe_torch.table import Table, from_plane, plane


def _stack(rows):
    """Per-shard tuples of tensors -> one (S, ...) tensor per position."""
    return tuple(torch.stack(list(col)) for col in zip(*rows))


def _u32(p: torch.Tensor) -> torch.Tensor:
    """An int32 plane as a u32 Table column."""
    return from_plane(p, torch.uint32)


def _capacity(capacity, factor, n_local, n_dev):
    if capacity is not None:
        return capacity
    return max(int(np.ceil(factor * n_local / n_dev)), 16)


def _auto_capacity(kw, mesh, plan_fn, keys, out_names):
    """Resolve capacity_factor="auto" into demand-sized capacities by a
    plan pass (the shared plan-then-execute step of every numpy wrapper).
    Returns kw unchanged unless "auto" was requested."""
    if kw.get("capacity_factor") != "auto":
        return kw
    kw = dict(kw)
    del kw["capacity_factor"]
    kw.pop("capacity_factor_right", None)
    if mesh.n_dev > 1:
        demands = plan_fn(*keys, mesh,
                          samples_per_dev=kw.get("samples_per_dev", 128),
                          backend=kw.get("backend", "radix"))
        if not isinstance(demands, tuple):
            demands = (demands,)
        for name, d in zip(out_names, demands):
            kw[name] = pow2_capacity(int(d.max()))
    return kw


def _prefixes(mesh, cols, counts):
    """The first counts[d] rows of every shard's padded columns,
    concatenated over the mesh: u32 numpy arrays."""
    counts = mesh.collect(counts).cpu().numpy().reshape(-1)
    out = []
    for c in cols:
        a = collect_u32(c, mesh)
        out.append(np.concatenate([a[d, :int(v)]
                                   for d, v in enumerate(counts)]))
    return out


# --------------------------------------------------------------------------
# distributed FK join
# --------------------------------------------------------------------------

def _djoin_exchange(mesh, llo, lhi, lval_cols, rlo, rhi, rval_cols, *,
                    n_dev, samples_per_dev, cap_l, cap_r, backend):
    """The join's keyed co-location exchange: (key, position) splitters
    over both sides, straddler broadcast, per-side capacities. Returns
    the per-shard join inputs, shared by the plain join and the fused
    join -> GROUP BY."""
    shards, n_local_l = llo.shape
    n_local_r = rlo.shape[1]
    dev = llo.device
    gidx = _global_pos(mesh, n_local_l, dev)
    # (key, left-position) splitters over both sides: hot left keys split
    # across a shard range; right rows sort first within a key (position
    # 0) and go to the first shard of their key's range
    pos_l = gidx
    pos_r = torch.zeros_like(rlo)
    sp = sample_splitters_pos(mesh, torch.cat([rlo, llo], 1),
                              torch.cat([rhi, lhi], 1),
                              torch.cat([pos_r, pos_l], 1), n_dev,
                              samples_per_dev, backend)
    dest_r = route_by_splitters_pos(rlo, rhi, pos_r, *sp)
    dest_r_max = route_by_splitters_pos(rlo, rhi, torch.full_like(rlo, -1),
                                        *sp)
    spans = dest_r_max > dest_r
    recv_r, flag_r, _, _, ovf_r = exchange(
        mesh, dest_r, [rlo, rhi] + list(rval_cols),
        [ONES, ONES] + [0] * len(rval_cols), n_dev, cap_r, backend)

    # broadcast the straddling right rows: each shard's first nspan (the
    # global bound for unique right keys) in row order, all_gathered
    nspan = max(n_dev - 1, 1)
    assert n_local_r < (1 << 31), n_local_r
    n_span_local = spans.sum(1)
    # more straddlers than the bound (duplicate right keys) is detected
    ovf_span = (n_span_local > nspan).to(torch.int64)
    rank = torch.cumsum(spans.to(torch.int64), 1) - 1
    slot = torch.where(spans & (rank < nspan), rank, nspan)
    sel = torch.zeros(shards, nspan + 1, dtype=torch.int64, device=dev)
    sel.scatter_(1, slot, torch.arange(n_local_r, device=dev).expand(
        shards, -1).contiguous())
    sel = torch.clamp(sel[:, :nspan], max=max(n_local_r - 1, 0))
    pad_slot = torch.arange(nspan, device=dev) >= n_span_local[:, None]

    def bc(col, fill):
        c = torch.where(pad_slot, i32(fill), col.gather(1, sel))
        return mesh.all_gather(c)                 # (S, D * nspan)

    bc_lo, bc_hi = bc(rlo, ONES), bc(rhi, ONES)
    bc_vals = [bc(c, 0) for c in rval_cols]
    bc_pad = mesh.all_gather(pad_slot.to(torch.int32))

    dest_l = route_by_splitters_pos(llo, lhi, pos_l, *sp)
    recv_l, flag_l, _, _, ovf_l = exchange(
        mesh, dest_l, [llo, lhi, gidx] + list(lval_cols),
        [ONES, ONES, ONES] + [0] * len(lval_cols), n_dev, cap_l, backend)

    # right set = exchanged rows + broadcast straddlers (a straddler also
    # arrives on its first shard by the exchange: the same row, so the FK
    # join's last-wins makes the duplicate harmless)
    lkey = (recv_l[0], recv_l[1])
    rkey = (torch.cat([recv_r[0], bc_lo], 1), torch.cat([recv_r[1], bc_hi],
                                                        1))
    r_valid = torch.cat([flag_r == 0, bc_pad == 0], 1)
    right_vals = [torch.cat([c, b], 1) for c, b in zip(recv_r[2:], bc_vals)]
    overflow = ovf_r | ovf_l | ovf_span
    return (lkey, recv_l[2], flag_l, list(recv_l[3:]), rkey, r_valid,
            right_vals, overflow)


def _djoin_shard(mesh, llo, lhi, lval_cols, rlo, rhi, rval_cols, *, n_dev,
                 samples_per_dev, cap_l, cap_r, backend):
    (lkey, g, flag_l, left_vals, rkey, r_valid, right_vals,
     overflow) = _djoin_exchange(mesh, llo, lhi, lval_cols, rlo, rhi,
                                 rval_cols, n_dev=n_dev,
                                 samples_per_dev=samples_per_dev,
                                 cap_l=cap_l, cap_r=cap_r, backend=backend)
    rows = []
    for s in range(llo.shape[0]):
        left = Table({f"_l{i}": _u32(c[s]) for i, c in enumerate(left_vals)})
        right = Table({f"_r{i}": _u32(c[s])
                       for i, c in enumerate(right_vals)})
        out, matched = join_fk_scan(
            left, right, U64(lkey[0][s], lkey[1][s]),
            U64(rkey[0][s], rkey[1][s]), l_valid=flag_l[s] == 0,
            r_valid=r_valid[s], backend=backend)
        rows.append([matched.to(torch.int32)]
                    + [plane(out[f"_l{i}"]) for i in range(len(left_vals))]
                    + [plane(out[f"_r{i}"])
                       for i in range(len(right_vals))])
    matched, *vals = _stack(rows)
    return (g, matched, flag_l, *vals, overflow)


def _djoin_plan(mesh, llo, lhi, rlo, rhi, *, n_dev, samples_per_dev,
                backend):
    """Planning pass of the join: route both sides exactly like
    _djoin_exchange; the largest off-diagonal bucket of each side."""
    gidx = _global_pos(mesh, llo.shape[1], llo.device)
    pos_r = torch.zeros_like(rlo)
    sp = sample_splitters_pos(mesh, torch.cat([rlo, llo], 1),
                              torch.cat([rhi, lhi], 1),
                              torch.cat([pos_r, gidx], 1), n_dev,
                              samples_per_dev, backend)
    dest_l = route_by_splitters_pos(llo, lhi, gidx, *sp)
    dest_r = route_by_splitters_pos(rlo, rhi, pos_r, *sp)
    return (offdiag_demand(mesh, dest_l, n_dev),
            offdiag_demand(mesh, dest_r, n_dev))


def plan_join_capacity(lkey: U64, rkey: U64, mesh,
                       samples_per_dev: int = 128, backend: str = "radix"):
    """Measured off-diagonal exchange demand (left, right) of the FK
    join, (S,) int64 each."""
    return _djoin_plan(mesh, lkey.lo, lkey.hi, rkey.lo, rkey.hi,
                       n_dev=mesh.n_dev, samples_per_dev=samples_per_dev,
                       backend=backend)


def _join_caps(n_local_l, n_local_r, n_dev, capacity_factor,
               capacity_factor_right, capacity_left, capacity_right):
    """Per-side off-diagonal capacities: the right side may take its own
    factor (the splitters balance the union of both sides, so the smaller
    side can concentrate)."""
    cf_r = (capacity_factor if capacity_factor_right is None
            else capacity_factor_right)
    return (_capacity(capacity_left, capacity_factor, n_local_l, n_dev),
            _capacity(capacity_right, cf_r, n_local_r, n_dev))


def distributed_join_fk(lkey: U64, left_cols: tuple, rkey: U64,
                        right_cols: tuple, mesh, samples_per_dev: int = 128,
                        capacity_factor: float = 2.0,
                        capacity_factor_right: float | None = None,
                        capacity_left: int | None = None,
                        capacity_right: int | None = None,
                        backend: str = "radix"):
    """FK equi-join of sharded tables.

    Args:
      lkey / rkey: U64 of (S, n_local) planes; left_cols / right_cols:
        tuples of (S, n_local) int32 planes of u32 values.
      capacity_left / right: explicit off-diagonal capacities (e.g. from
        plan_join_capacity); override the factors.
    Returns (global_left_index, matched, pad_flag, *out_left_cols,
    *out_right_cols, overflow), per-shard padded int32 planes (overflow
    (S,) int64); rows with pad_flag 0 are real.
    """
    n_dev = mesh.n_dev
    n_local_l, n_local_r = lkey.lo.shape[1], rkey.lo.shape[1]
    assert n_local_l * n_dev < (1 << 32), n_local_l   # u32 left indices
    cap_l, cap_r = _join_caps(n_local_l, n_local_r, n_dev, capacity_factor,
                              capacity_factor_right, capacity_left,
                              capacity_right)
    return _djoin_shard(mesh, lkey.lo, lkey.hi, tuple(left_cols), rkey.lo,
                        rkey.hi, tuple(right_cols), n_dev=n_dev,
                        samples_per_dev=samples_per_dev, cap_l=cap_l,
                        cap_r=cap_r, backend=backend)


def _shard_cols(vals, mesh):
    return tuple(shard_u32(np.asarray(v, dtype=np.uint32), mesh)
                 for v in vals)


def _check_overflow(ovf, what="exchange capacity overflow; raise "
                              "capacity_factor"):
    if int(ovf.max()):
        raise RuntimeError(what)


def distributed_join_fk_numpy(lkeys, lvals, rkeys, rvals, mesh, **kw):
    """Host wrapper: (matched, right value columns) in the original left
    order. capacity_factor="auto" plans both exchanges first."""
    lk, rk = shard_u64(lkeys, mesh), shard_u64(rkeys, mesh)
    kw = _auto_capacity(kw, mesh, plan_join_capacity, (lk, rk),
                        ("capacity_left", "capacity_right"))
    res = distributed_join_fk(lk, _shard_cols(lvals, mesh), rk,
                              _shard_cols(rvals, mesh), mesh=mesh, **kw)
    _check_overflow(res[-1])
    g, matched, flag = (collect_u32(c, mesh).reshape(-1) for c in res[:3])
    rcols = [collect_u32(c, mesh).reshape(-1)
             for c in res[3 + len(lvals):-1]]
    real = flag == 0
    n_l = len(lkeys)
    out_matched = np.zeros(n_l, dtype=bool)
    out_rvals = [np.zeros(n_l, dtype=np.uint32) for _ in rcols]
    gi = g[real]
    out_matched[gi] = matched[real] > 0
    for o, c in zip(out_rvals, rcols):
        o[gi] = c[real]
    return out_matched, out_rvals


# --------------------------------------------------------------------------
# distributed one-to-many inner join
# --------------------------------------------------------------------------

def _bare_key_exchange(mesh, llo, lhi, lval_cols, rlo, rhi, rval_cols, *,
                       n_dev, samples_per_dev, cap_l, cap_r, backend):
    """Bare-key splitters over the union (every copy of a key, left and
    right, on one shard: a hot key's whole match set lands on one shard)
    and both sides' exchanges."""
    gidx = _global_pos(mesh, llo.shape[1], llo.device)
    sp = sample_splitters(mesh, torch.cat([rlo, llo], 1),
                          torch.cat([rhi, lhi], 1), n_dev, samples_per_dev,
                          backend=backend)
    dest_l = route_by_splitters(llo, lhi, *sp)
    dest_r = route_by_splitters(rlo, rhi, *sp)
    recv_l, flag_l, _, _, ovf_l = exchange(
        mesh, dest_l, [llo, lhi, gidx] + list(lval_cols),
        [ONES, ONES, ONES] + [0] * len(lval_cols), n_dev, cap_l, backend)
    recv_r, flag_r, _, _, ovf_r = exchange(
        mesh, dest_r, [rlo, rhi] + list(rval_cols),
        [ONES, ONES] + [0] * len(rval_cols), n_dev, cap_r, backend)
    return recv_l, flag_l, recv_r, flag_r, ovf_l | ovf_r


def _padded_sides(recv_l, flag_l, recv_r, flag_r, s):
    """Shard s's (left, right, lkey, rkey, l_valid, r_valid) join inputs."""
    left = Table({"_g": _u32(recv_l[2][s]),
                  **{f"_l{i}": _u32(c[s])
                     for i, c in enumerate(recv_l[3:])}})
    right = Table({f"_r{i}": _u32(c[s]) for i, c in enumerate(recv_r[2:])})
    return (left, right, U64(recv_l[0][s], recv_l[1][s]),
            U64(recv_r[0][s], recv_r[1][s]), flag_l[s] == 0,
            flag_r[s] == 0)


def _table_planes(t: Table, n_l: int, n_r: int):
    return ([plane(t["_g"])] + [plane(t[f"_l{i}"]) for i in range(n_l)]
            + [plane(t[f"_r{i}"]) for i in range(n_r)])


def _djoin_inner_shard(mesh, llo, lhi, lval_cols, rlo, rhi, rval_cols, *,
                       n_dev, samples_per_dev, cap_l, cap_r, out_budget,
                       backend):
    recv_l, flag_l, recv_r, flag_r, ovf = _bare_key_exchange(
        mesh, llo, lhi, lval_cols, rlo, rhi, rval_cols, n_dev=n_dev,
        samples_per_dev=samples_per_dev, cap_l=cap_l, cap_r=cap_r,
        backend=backend)
    rows = []
    for s in range(llo.shape[0]):
        res = join_inner_padded(*_padded_sides(recv_l, flag_l, recv_r,
                                               flag_r, s), out_budget,
                                backend=backend)
        rows.append(_table_planes(res.table, len(lval_cols),
                                  len(rval_cols))
                    + [res.num_out, res.overflow])
    *cols, num_out, res_ovf = _stack(rows)
    return (*cols, num_out, ovf | res_ovf)


def _djoin_inner_plan(mesh, llo, lhi, rlo, rhi, *, n_dev, samples_per_dev,
                      backend):
    sp = sample_splitters(mesh, torch.cat([rlo, llo], 1),
                          torch.cat([rhi, lhi], 1), n_dev, samples_per_dev,
                          backend=backend)
    return (offdiag_demand(mesh, route_by_splitters(llo, lhi, *sp), n_dev),
            offdiag_demand(mesh, route_by_splitters(rlo, rhi, *sp), n_dev))


def plan_join_inner_capacity(lkey: U64, rkey: U64, mesh,
                             samples_per_dev: int = 128,
                             backend: str = "radix"):
    """Measured off-diagonal exchange demand (left, right) of the inner
    (and outer) join; the output budget stays a factor (match counts are
    data-dependent and their overflow is detected exactly)."""
    return _djoin_inner_plan(mesh, lkey.lo, lkey.hi, rkey.lo, rkey.hi,
                             n_dev=mesh.n_dev,
                             samples_per_dev=samples_per_dev,
                             backend=backend)


def distributed_join_inner(lkey: U64, left_cols: tuple, rkey: U64,
                           right_cols: tuple, mesh,
                           samples_per_dev: int = 128,
                           capacity_factor: float = 2.0,
                           capacity_factor_right: float | None = None,
                           out_budget_factor: float = 4.0,
                           capacity_left: int | None = None,
                           capacity_right: int | None = None,
                           backend: str = "radix"):
    """One-to-many inner equi-join of sharded tables: each shard writes
    its matches into a padded budget of out_budget_factor * n_l_local
    rows. Returns per-shard (global_left_index, left value cols, right
    value cols, num_out, overflow); slots [0, num_out[s]) of shard s are
    real."""
    n_dev = mesh.n_dev
    n_local_l, n_local_r = lkey.lo.shape[1], rkey.lo.shape[1]
    assert n_local_l * n_dev < (1 << 32), n_local_l
    cap_l, cap_r = _join_caps(n_local_l, n_local_r, n_dev, capacity_factor,
                              capacity_factor_right, capacity_left,
                              capacity_right)
    out_budget = max(int(np.ceil(out_budget_factor * n_local_l)), 16)
    return _djoin_inner_shard(
        mesh, lkey.lo, lkey.hi, tuple(left_cols), rkey.lo, rkey.hi,
        tuple(right_cols), n_dev=n_dev, samples_per_dev=samples_per_dev,
        cap_l=cap_l, cap_r=cap_r, out_budget=out_budget, backend=backend)


_BUDGET = ("exchange capacity or output budget overflow; raise "
           "capacity_factor / out_budget_factor")


def distributed_join_inner_numpy(lkeys, lvals, rkeys, rvals, mesh, **kw):
    """Host wrapper: (left_index, left value cols, right value cols) over
    all real output rows, in no particular global order."""
    lk, rk = shard_u64(lkeys, mesh), shard_u64(rkeys, mesh)
    kw = _auto_capacity(kw, mesh, plan_join_inner_capacity, (lk, rk),
                        ("capacity_left", "capacity_right"))
    res = distributed_join_inner(lk, _shard_cols(lvals, mesh), rk,
                                 _shard_cols(rvals, mesh), mesh=mesh, **kw)
    _check_overflow(res[-1], _BUDGET)
    picks = _prefixes(mesh, res[:-2], res[-2])
    return (picks[0], picks[1:1 + len(lvals)], picks[1 + len(lvals):])


# --------------------------------------------------------------------------
# distributed outer join (LEFT / FULL)
# --------------------------------------------------------------------------

def _djoin_outer_shard(mesh, llo, lhi, lval_cols, rlo, rhi, rval_cols, *,
                       n_dev, samples_per_dev, cap_l, cap_r, out_budget,
                       full, backend):
    """The inner join's co-location (all copies of a key on one shard, so
    each shard's outer verdict is globally exact) + join_outer_padded."""
    recv_l, flag_l, recv_r, flag_r, ovf = _bare_key_exchange(
        mesh, llo, lhi, lval_cols, rlo, rhi, rval_cols, n_dev=n_dev,
        samples_per_dev=samples_per_dev, cap_l=cap_l, cap_r=cap_r,
        backend=backend)
    rows = []
    for s in range(llo.shape[0]):
        res = join_outer_padded(*_padded_sides(recv_l, flag_l, recv_r,
                                               flag_r, s), out_budget,
                                full=full, backend=backend)
        row = (_table_planes(res.table, len(lval_cols), len(rval_cols))
               + [res.matched.to(torch.int32), res.num_out, res.overflow])
        if full:
            ro = res.right_only
            row += ([ro["_key"].lo, ro["_key"].hi]
                    + [plane(ro[f"_r{i}"]) for i in range(len(rval_cols))]
                    + [res.num_right_only])
        rows.append(row)
    out = list(_stack(rows))
    n_main = 1 + len(lval_cols) + len(rval_cols) + 1
    out[n_main + 1] = out[n_main + 1] | ovf
    return tuple(out)


def distributed_join_outer(lkey: U64, left_cols: tuple, rkey: U64,
                           right_cols: tuple, mesh,
                           samples_per_dev: int = 128,
                           capacity_factor: float = 2.0,
                           capacity_factor_right: float | None = None,
                           out_budget_factor: float = 4.0,
                           capacity_left: int | None = None,
                           capacity_right: int | None = None,
                           full: bool = False, backend: str = "radix"):
    """One-to-many LEFT (or FULL) OUTER equi-join of sharded tables:
    unmatched left rows keep one NULL-right slot; FULL adds each shard's
    unmatched right rows. Returns per-shard (global_left_index, left cols,
    right cols, matched, num_out, overflow[, ro_key_lo, ro_key_hi, ro
    right cols, num_right_only])."""
    n_dev = mesh.n_dev
    n_local_l, n_local_r = lkey.lo.shape[1], rkey.lo.shape[1]
    assert n_local_l * n_dev < (1 << 32), n_local_l
    cap_l, cap_r = _join_caps(n_local_l, n_local_r, n_dev, capacity_factor,
                              capacity_factor_right, capacity_left,
                              capacity_right)
    out_budget = max(int(np.ceil(out_budget_factor * n_local_l)), 16)
    return _djoin_outer_shard(
        mesh, lkey.lo, lkey.hi, tuple(left_cols), rkey.lo, rkey.hi,
        tuple(right_cols), n_dev=n_dev, samples_per_dev=samples_per_dev,
        cap_l=cap_l, cap_r=cap_r, out_budget=out_budget, full=full,
        backend=backend)


def distributed_join_outer_numpy(lkeys, lvals, rkeys, rvals, mesh,
                                 full=False, **kw):
    """Host wrapper: (left_index, left cols, right cols, matched) over all
    real outer-join rows (no particular global order), plus (ro_keys, ro
    cols) when full=True."""
    lk, rk = shard_u64(lkeys, mesh), shard_u64(rkeys, mesh)
    kw = _auto_capacity(kw, mesh, plan_join_inner_capacity, (lk, rk),
                        ("capacity_left", "capacity_right"))
    res = distributed_join_outer(lk, _shard_cols(lvals, mesh), rk,
                                 _shard_cols(rvals, mesh), mesh=mesh,
                                 full=full, **kw)
    n_main = 1 + len(lvals) + len(rvals) + 1
    _check_overflow(res[n_main + 1], _BUDGET)
    picks = _prefixes(mesh, res[:n_main], res[n_main])
    g = picks[0]
    lcols = picks[1:1 + len(lvals)]
    rcols = picks[1 + len(lvals):1 + len(lvals) + len(rvals)]
    matched = picks[-1].astype(bool)
    if not full:
        return g, lcols, rcols, matched
    ro = res[n_main + 2:]
    ro_picks = _prefixes(mesh, ro[:-1], ro[-1])
    ro_keys = (ro_picks[0].astype(np.uint64)
               | (ro_picks[1].astype(np.uint64) << np.uint64(32)))
    return g, lcols, rcols, matched, ro_keys, ro_picks[2:]


# --------------------------------------------------------------------------
# distributed top-k
# --------------------------------------------------------------------------

def _dtopk_shard(mesh, lo, hi, *cols, k, largest, backend):
    """Local top-k per shard, all_gather of the k*D candidates, one more
    selection. Both sorts are stable, so ties keep the global row order:
    within a shard the row order, across shards the rank order of the
    gathered candidates."""
    shards, n_local = lo.shape
    gidx = _global_pos(mesh, n_local, lo.device)
    whi, wlo = (~hi, ~lo) if largest else (hi, lo)
    shard = torch.arange(shards, dtype=torch.int32,
                         device=lo.device)[:, None].expand(-1, n_local)
    planes = [whi, wlo, gidx] + list(cols)
    keys = [whi.reshape(-1), wlo.reshape(-1)]
    bits = [32, 32]
    if shards > 1:
        keys, bits = [shard.reshape(-1)] + keys, [
            max((shards - 1).bit_length(), 1)] + bits
    _, perm = argsort_planes(keys, bits, backend)
    kk = min(k, n_local)      # a shard contributes at most all its rows
    best = perm.reshape(shards, n_local)[:, :kk].to(torch.int64)
    best = best - torch.arange(shards, device=lo.device)[:, None] * n_local
    cand = [mesh.all_gather(p.gather(1, best))[0] for p in planes]
    res = sort_planes(cand, 2, backend=backend)
    out = [r[:k] for r in res]
    o_hi, o_lo = (~out[0], ~out[1]) if largest else (out[0], out[1])
    return (o_lo, o_hi, *out[2:])


def distributed_top_k(key: U64, cols: tuple, mesh, k: int,
                      largest: bool = False, backend: str = "radix"):
    """k globally best rows of a sharded table, the same on every shard:
    (lo, hi, global_row_index, *value cols), (k,) int32 planes each, best
    first; ties by global row order (the single-device ops.topk
    result)."""
    n = key.lo.shape[1] * mesh.n_dev
    assert n < (1 << 32)
    assert 0 < k <= n, (k, n)
    return _dtopk_shard(mesh, key.lo, key.hi, *cols, k=k, largest=largest,
                        backend=backend)


def distributed_top_k_numpy(keys, vals, mesh, k, largest=False, **kw):
    """Host wrapper: (keys_k, global_indices_k, value_cols_k)."""
    out = distributed_top_k(shard_u64(keys, mesh), _shard_cols(vals, mesh),
                            mesh=mesh, k=k, largest=largest, **kw)
    lo, hi, g, *rest = (o.cpu().numpy().view(np.uint32) for o in out)
    ks = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    return ks, g, rest


# --------------------------------------------------------------------------
# distributed GROUP BY aggregate
# --------------------------------------------------------------------------

def _neutral(agg: str, is_float: bool) -> int:
    """Padding-slot value whose contribution the combine ignores, as a
    u32 bit pattern."""
    if is_float and agg != "count":
        v = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}[agg]
        return int(np.float32(v).view(np.uint32))
    return {"count": 0, "sum": 0, "min": 0xFFFFFFFF, "max": 0}[agg]


def _inner_aggs(aggs) -> tuple:
    """The requested aggs plus a trailing count (it marks padding groups)
    unless requested."""
    return tuple(aggs) if "count" in aggs else tuple(aggs) + ("count",)


def _value_column(v: torch.Tensor) -> torch.Tensor:
    """A value plane or column as the local operators' column: float32
    stays float, every other 32-bit type aggregates its u32 bits."""
    return v if v.dtype == torch.float32 else _u32(plane(v))


def _agg_planes(res, inner_aggs, is_float):
    """A GroupResult's aggregates as exchange planes: an integer sum is
    its (lo, hi) u64 pair, a count its u32 value, the rest their bits."""
    out = []
    for a in inner_aggs:
        col = res.aggs[a]
        if isinstance(col, U64):
            out += [col.lo, col.hi]
        elif a == "count":
            out.append(narrow(col))
        else:
            out.append(col.view(torch.int32))
    return out


def _combine_shard(klo, khi, cols, inner_aggs, is_float, backend):
    """Phase 3 on one shard: sort the received partials by key, reduce
    each key's run (counts and sums by segmented sums, integer sums as
    carried u64 pairs, min / max by segmented scans) and move the group
    ends to the front."""
    m = klo.shape[0]
    assert m < (1 << 31), m
    res = sort_planes([khi, klo] + cols, 2, backend=backend)
    skhi, sklo, scols = res[0], res[1], res[2:]
    pos = torch.arange(m, device=klo.device)
    is_new = ((pos == 0) | (sklo != _shift_right_one(sklo, 0))
              | (skhi != _shift_right_one(skhi, 0)))
    is_end = _ends(is_new)
    reduced = []
    j = 0
    for a in inner_aggs:
        if a == "sum" and not is_float:
            reduced += list(segmented_sum_u64(scols[j], scols[j + 1],
                                              is_new))
            j += 2
            continue
        v = scols[j].view(torch.float32) if is_float and a != "count" \
            else _u32(scols[j])
        j += 1
        reduced.append(plane(segmented_reduce(
            v, is_new, "sum" if a == "count" else a)))
    order = stable_partition(is_end)
    return ([sklo[order], skhi[order]] + [r[order] for r in reduced]
            + [is_end.sum()])


def _partials_to_global(mesh, part_lo, part_hi, part_cols, num_groups,
                        inner_aggs, is_float, *, n_dev, samples_per_dev,
                        capacity, backend):
    """Phases 2-3 of two-phase aggregation over per-shard padded partial
    groups ((S, m) planes, the first num_groups[s] real): shuffle them by
    key splitters, combine the received partials per key. Shared by the
    aggregate and the fused join -> GROUP BY."""
    m = part_lo.shape[1]
    is_real = torch.arange(m, device=part_lo.device) < num_groups[:, None]
    klo = torch.where(is_real, part_lo, -1)
    khi = torch.where(is_real, part_hi, -1)
    pads = []
    for a in inner_aggs:
        n_planes = 2 if a == "sum" and not is_float else 1
        pads += [_neutral(a, is_float)] * n_planes
    partials = [torch.where(is_real, p, i32(nv))
                for p, nv in zip(part_cols, pads)]
    # sample only the real prefix; pads route to their own shard, so they
    # never enter the all_to_all
    sp = sample_splitters(mesh, klo, khi, n_dev, samples_per_dev,
                          n_valid=num_groups, backend=backend)
    dest = torch.where(is_real, route_by_splitters(klo, khi, *sp),
                       mesh.ranks()[:, None].to(torch.int32))
    recv, _, _, _, overflow = exchange(mesh, dest, [klo, khi] + partials,
                                       [ONES, ONES] + pads, n_dev, capacity,
                                       backend)
    out = _stack([_combine_shard(recv[0][s], recv[1][s],
                                 [c[s] for c in recv[2:]], inner_aggs,
                                 is_float, backend)
                  for s in range(part_lo.shape[0])])
    return (*out, overflow)


def _local_partials(lo, hi, value, inner_aggs, is_float, backend):
    """Phase 1: group_aggregate per shard, stacked into (S, n) planes."""
    rows = []
    for s in range(lo.shape[0]):
        v = None if value is None else _value_column(value[s])
        res = group_aggregate(U64(lo[s], hi[s]), v, aggs=inner_aggs,
                              backend=backend)
        rows.append([res.key.lo, res.key.hi, res.num_groups]
                    + _agg_planes(res, inner_aggs, is_float))
    plo, phi, ng, *cols = _stack(rows)
    return plo, phi, cols, ng


def _dagg_plan(mesh, lo, hi, *, n_dev, samples_per_dev, backend):
    """Planning pass of the aggregate: phase 1 on keys only, the partial
    groups routed exactly like the execute pass."""
    plo, phi, _, ng = _local_partials(lo, hi, None, ("count",), False,
                                      backend)
    is_real = torch.arange(plo.shape[1], device=lo.device) < ng[:, None]
    klo, khi = torch.where(is_real, plo, -1), torch.where(is_real, phi, -1)
    sp = sample_splitters(mesh, klo, khi, n_dev, samples_per_dev,
                          n_valid=ng, backend=backend)
    dest = torch.where(is_real, route_by_splitters(klo, khi, *sp),
                       mesh.ranks()[:, None].to(torch.int32))
    return offdiag_demand(mesh, dest, n_dev)


def plan_aggregate_capacity(key: U64, mesh, samples_per_dev: int = 128,
                            backend: str = "radix"):
    """Measured off-diagonal partial-group exchange demand of
    distributed_aggregate, (S,) int64."""
    return _dagg_plan(mesh, key.lo, key.hi, n_dev=mesh.n_dev,
                      samples_per_dev=samples_per_dev, backend=backend)


def distributed_aggregate(key: U64, value: torch.Tensor, mesh,
                          aggs=("count", "sum"), samples_per_dev: int = 128,
                          capacity_factor: float = 2.0,
                          capacity: int | None = None,
                          backend: str = "radix"):
    """GROUP BY over sharded rows (two-phase aggregation).

    value: (S, n_local) float32 tensor, or u32 / i32 (their u32 bits).
    Returns (klo, khi, *agg planes in inner order, num_groups, overflow):
    inner order is the requested aggs plus a trailing count if it was not
    requested; an integer sum gives two planes (its exact u64 (lo, hi)).
    """
    n_dev = mesh.n_dev
    n_local = key.lo.shape[1]
    inner_aggs = _inner_aggs(aggs)
    capacity = max(_capacity(capacity, capacity_factor, n_local, n_dev), 16)
    is_float = value.dtype == torch.float32
    plo, phi, cols, ng = _local_partials(key.lo, key.hi, value, inner_aggs,
                                         is_float, backend)
    return _partials_to_global(mesh, plo, phi, cols, ng, inner_aggs,
                               is_float, n_dev=n_dev,
                               samples_per_dev=samples_per_dev,
                               capacity=capacity, backend=backend)


def _groups_numpy(mesh, res, aggs, is_float):
    """{key -> {agg -> value}} from an aggregate-shaped result; padding
    groups (count 0) dropped."""
    inner = _inner_aggs(aggs)
    klo, khi = collect_u32(res[0], mesh), collect_u32(res[1], mesh)
    cols = []
    j = 0
    res_cols = res[2:-2]
    for a in inner:
        if a == "sum" and not is_float:
            lo_c = collect_u32(res_cols[j], mesh)
            hi_c = collect_u32(res_cols[j + 1], mesh)
            j += 2
            cols.append(lo_c.astype(np.uint64)
                        | (hi_c.astype(np.uint64) << np.uint64(32)))
            continue
        c = collect_u32(res_cols[j], mesh)
        j += 1
        cols.append(c.view(np.float32) if is_float and a != "count" else c)
    ng = mesh.collect(res[-2]).cpu().numpy()
    out = {}
    for d in range(mesh.n_dev):
        for i in range(int(ng[d])):
            k = int(klo[d, i]) | (int(khi[d, i]) << 32)
            row = {a: (float(c[d, i]) if is_float and a != "count"
                       else int(c[d, i])) for a, c in zip(inner, cols)}
            if row["count"] == 0:
                continue  # purely-padding group
            out[k] = {a: row[a] for a in aggs}
    return out


def distributed_aggregate_numpy(keys, values, mesh, aggs=("count", "sum"),
                                **kw):
    """Host wrapper: {key -> {agg -> value}} over all shards.

    Integer sums are exact (u64 pair sums end to end); min / max compare
    u32 bit patterns; float32 values aggregate as floats. A signed column
    with negatives is refused for min / max (it would compare unsigned).
    capacity_factor="auto" plans the partial-group exchange first.
    """
    key = shard_u64(keys, mesh)
    kw = _auto_capacity(kw, mesh, plan_aggregate_capacity, (key,),
                        ("capacity",))
    values = np.asarray(values)
    is_float = values.dtype == np.float32
    if is_float:
        val = shard_u32(values, mesh).view(torch.float32)
    else:
        if (np.issubdtype(values.dtype, np.signedinteger)
                and ({"min", "max"} & set(aggs)) and bool((values < 0).any())):
            raise ValueError(
                "min/max over signed values with negatives would aggregate "
                "in unsigned order; bias-map to sortable u32 first "
                "(v.astype(np.int64) + 2**31 -> uint32) and invert on output")
        val = _u32(shard_u32(values.astype(np.uint32), mesh))
    res = distributed_aggregate(key, val, mesh=mesh, aggs=tuple(aggs), **kw)
    _check_overflow(res[-1])
    return _groups_numpy(mesh, res, aggs, is_float)


# --------------------------------------------------------------------------
# distributed COUNT(DISTINCT value) GROUP BY key
# --------------------------------------------------------------------------

def _dcd_dedup_local(lo, hi, val, backend):
    """One shard's rows sorted by (key, value), the distinct pairs moved
    to the front: (klo, khi, v, m), the m distinct pairs a prefix. The
    dedup is the exchange-volume reducer."""
    shi, slo, sv = sort_planes([hi, lo, val], 3, backend=backend)
    new = ((slo != _shift_right_one(slo, 0)) | (shi != _shift_right_one(
        shi, 0)) | (sv != _shift_right_one(sv, 0)))
    new[:1] = True
    order = stable_partition(new)
    return slo[order], shi[order], sv[order], new.sum()


def _dcd_route(mesh, lo, hi, val, *, n_dev, samples_per_dev, backend):
    """Dedup + key-splitter routing, shared by the execute and plan
    passes (identical routing makes the plan's demand exact)."""
    clo, chi, cv, m = _stack([_dcd_dedup_local(lo[s], hi[s], val[s],
                                               backend)
                              for s in range(lo.shape[0])])
    is_real = torch.arange(clo.shape[1], device=lo.device) < m[:, None]
    klo, khi = torch.where(is_real, clo, -1), torch.where(is_real, chi, -1)
    sp = sample_splitters(mesh, klo, khi, n_dev, samples_per_dev,
                          n_valid=m, backend=backend)
    dest = torch.where(is_real, route_by_splitters(klo, khi, *sp),
                       mesh.ranks()[:, None].to(torch.int32))
    return klo, khi, cv, is_real, dest


def plan_count_distinct_capacity(key: U64, value: torch.Tensor, mesh,
                                 samples_per_dev: int = 128,
                                 backend: str = "radix"):
    """Measured off-diagonal distinct-pair exchange demand, (S,) int64."""
    dest = _dcd_route(mesh, key.lo, key.hi, plane(value), n_dev=mesh.n_dev,
                      samples_per_dev=samples_per_dev, backend=backend)[-1]
    return offdiag_demand(mesh, dest, mesh.n_dev)


def distributed_count_distinct(key: U64, value: torch.Tensor, mesh,
                               samples_per_dev: int = 128,
                               capacity_factor: float = 2.0,
                               capacity: int | None = None,
                               backend: str = "radix"):
    """COUNT(DISTINCT value) GROUP BY key over sharded rows: local
    (key, value) dedup, distinct pairs routed by key splitters (every pair
    of a key on one shard), pair runs counted there. Returns (klo, khi,
    count_distinct, num_groups, overflow); the first num_groups[s] rows
    of shard s are its groups."""
    n_dev = mesh.n_dev
    capacity = max(_capacity(capacity, capacity_factor, key.lo.shape[1],
                             n_dev), 16)
    klo, khi, cv, is_real, dest = _dcd_route(
        mesh, key.lo, key.hi, plane(value), n_dev=n_dev,
        samples_per_dev=samples_per_dev, backend=backend)
    # an explicit validity plane marks real slots: a pad value would
    # count as a value, and real all-ones keys stay exact
    recv, _, _, _, overflow = exchange(
        mesh, dest, [klo, khi, torch.where(is_real, cv, 0),
                     is_real.to(torch.int32)],
        [ONES, ONES, 0, 0], n_dev, capacity, backend)
    rows = []
    for s in range(klo.shape[0]):
        res = group_aggregate(U64(recv[0][s], recv[1][s]), _u32(recv[2][s]),
                              aggs=("count_distinct",),
                              valid=recv[3][s] > 0, backend=backend)
        rows.append([res.key.lo, res.key.hi,
                     narrow(res.aggs["count_distinct"]), res.num_groups])
    return (*_stack(rows), overflow)


def distributed_count_distinct_numpy(keys, values, mesh, **kw):
    """Host wrapper: {key -> distinct-value count} over all shards."""
    key = shard_u64(keys, mesh)
    val = shard_u32(np.asarray(values), mesh)
    kw = _auto_capacity(kw, mesh, plan_count_distinct_capacity, (key, val),
                        ("capacity",))
    res = distributed_count_distinct(key, val, mesh=mesh, **kw)
    _check_overflow(res[-1])
    klo, khi, cd = (collect_u32(c, mesh) for c in res[:3])
    ng = mesh.collect(res[3]).cpu().numpy()
    return {int(klo[d, i]) | (int(khi[d, i]) << 32): int(cd[d, i])
            for d in range(mesh.n_dev) for i in range(int(ng[d]))}


# --------------------------------------------------------------------------
# fused distributed join -> GROUP BY (the key-sorted stream never lands)
# --------------------------------------------------------------------------

def _djoin_agg_shard(mesh, llo, lhi, rlo, rhi, rval, *, n_dev,
                     samples_per_dev, cap_l, cap_r, cap_agg, inner_aggs,
                     backend):
    (lkey, g, flag_l, _, rkey, r_valid, right_vals,
     ovf_j) = _djoin_exchange(mesh, llo, lhi, (), rlo, rhi, (rval,),
                              n_dev=n_dev, samples_per_dev=samples_per_dev,
                              cap_l=cap_l, cap_r=cap_r, backend=backend)
    # the join's stream is key-sorted per shard: the partial groups come
    # from group_aggregate_sorted with no key sort of their own, and the
    # second exchange moves partial groups, not rows
    rows = []
    for s in range(llo.shape[0]):
        st = join_fk_scan(Table({"_z": torch.zeros_like(g[s])}),
                          Table({"_r0": _u32(right_vals[0][s])}),
                          U64(lkey[0][s], lkey[1][s]),
                          U64(rkey[0][s], rkey[1][s]), output="stream",
                          l_valid=flag_l[s] == 0, r_valid=r_valid[s],
                          backend=backend)
        part = group_aggregate_sorted(st.key, st.values["_r0"],
                                      aggs=inner_aggs, valid=st.matched)
        rows.append([part.key.lo, part.key.hi, part.num_groups]
                    + _agg_planes(part, inner_aggs, False))
    plo, phi, ng, *cols = _stack(rows)
    out = _partials_to_global(mesh, plo, phi, cols, ng, inner_aggs, False,
                              n_dev=n_dev, samples_per_dev=samples_per_dev,
                              capacity=cap_agg, backend=backend)
    return (*out[:-1], torch.maximum(ovf_j, out[-1]))


def distributed_join_aggregate(lkey: U64, rkey: U64, rvalue: torch.Tensor,
                               mesh, aggs=("count", "sum"),
                               samples_per_dev: int = 128,
                               capacity_factor: float = 2.0,
                               capacity_left: int | None = None,
                               capacity_right: int | None = None,
                               capacity_agg: int | None = None,
                               backend: str = "radix"):
    """SELECT l.key, aggs(r.value) FROM l JOIN r USING (key) GROUP BY
    l.key over sharded sides, fused: one join co-location exchange, a
    stream join + sorted partial aggregation per shard, one partial-group
    exchange. Returns the distributed_aggregate contract (klo, khi, agg
    planes incl. the trailing count, num_groups, overflow)."""
    n_dev = mesh.n_dev
    n_local_l, n_local_r = lkey.lo.shape[1], rkey.lo.shape[1]

    def cap(c, n_local):
        return max(_capacity(c, capacity_factor, n_local, n_dev), 16)

    return _djoin_agg_shard(
        mesh, lkey.lo, lkey.hi, rkey.lo, rkey.hi, plane(rvalue),
        n_dev=n_dev, samples_per_dev=samples_per_dev,
        cap_l=cap(capacity_left, n_local_l),
        cap_r=cap(capacity_right, n_local_r),
        cap_agg=cap(capacity_agg, n_local_l), inner_aggs=_inner_aggs(aggs),
        backend=backend)


def distributed_join_aggregate_numpy(lkeys, rkeys, rvals, mesh,
                                     aggs=("count", "sum"), **kw):
    """Host wrapper: {left key -> {agg -> value}} over matched rows;
    capacity_factor="auto" plans the join exchange (the partial-group
    stage sizes itself from the left capacity)."""
    lk, rk = shard_u64(lkeys, mesh), shard_u64(rkeys, mesh)
    rv = shard_u32(np.asarray(rvals).astype(np.uint32), mesh)
    kw = _auto_capacity(kw, mesh, plan_join_capacity, (lk, rk),
                        ("capacity_left", "capacity_right"))
    res = distributed_join_aggregate(lk, rk, rv, mesh=mesh,
                                     aggs=tuple(aggs), **kw)
    _check_overflow(res[-1])
    return _groups_numpy(mesh, res, aggs, False)


# --------------------------------------------------------------------------
# distributed set operations (UNION / INTERSECT / EXCEPT, distinct)
# --------------------------------------------------------------------------

def _dset_dedup_local(alo, ahi, blo, bhi, backend):
    """One shard's (key, side) tuples with their multiplicities, the m
    distinct tuples a prefix: (klo, khi, side, occ, m)."""
    n_a, n_b = alo.shape[0], blo.shape[0]
    side = torch.cat([torch.zeros(n_a, dtype=torch.int32, device=alo.device),
                      torch.ones(n_b, dtype=torch.int32, device=alo.device)])
    shi, slo, ss = sort_planes([torch.cat([ahi, bhi]), torch.cat([alo, blo]),
                                side], 3, [32, 32, 1], backend)
    new = ((slo != _shift_right_one(slo, 0)) | (shi != _shift_right_one(
        shi, 0)) | (ss != _shift_right_one(ss, 0)))
    new[:1] = True
    order = stable_partition(_ends(new))       # tuple ends, in order
    pe = order + 1
    occ = pe - _shift_right_one(pe, 0)
    return slo[order], shi[order], ss[order], narrow(occ), new.sum()


def _dset_dedup_route(mesh, alo, ahi, blo, bhi, *, n_dev, samples_per_dev,
                      backend):
    """Shared first phase: local (key, side) dedup with exact
    multiplicities (the exchange-volume reducer) + key-splitter routing;
    padded entries route to their own shard."""
    klo, khi, side, occ, m = _stack([
        _dset_dedup_local(alo[s], ahi[s], blo[s], bhi[s], backend)
        for s in range(alo.shape[0])])
    is_real = torch.arange(klo.shape[1], device=alo.device) < m[:, None]
    klo, khi = torch.where(is_real, klo, -1), torch.where(is_real, khi, -1)
    sp = sample_splitters(mesh, klo, khi, n_dev, samples_per_dev,
                          n_valid=m, backend=backend)
    dest = torch.where(is_real, route_by_splitters(klo, khi, *sp),
                       mesh.ranks()[:, None].to(torch.int32))
    return klo, khi, side, occ, is_real, dest


def plan_set_op_capacity(akey: U64, bkey: U64, mesh,
                         samples_per_dev: int = 128,
                         backend: str = "radix"):
    """Measured off-diagonal demand of the set-op exchange (distinct
    (key, side) tuples after the local dedup), (S,) int64."""
    dest = _dset_dedup_route(mesh, akey.lo, akey.hi, bkey.lo, bkey.hi,
                             n_dev=mesh.n_dev,
                             samples_per_dev=samples_per_dev,
                             backend=backend)[-1]
    return offdiag_demand(mesh, dest, mesh.n_dev)


def _dset_verdict(rlo, rhi, rs, ro, op, backend):
    """One shard's set op over its received (key, side, occ) tuples:
    (klo, khi, count_a, count_b, num), the num result keys a prefix.

    A pad slot has occ 0 (a real tuple at least 1): pads sort last, so a
    real all-ones key keeps its verdict."""
    pad = (ro == 0).to(torch.int32)
    spad, g2hi, g2lo, g2s, g2o = sort_planes([pad, rhi, rlo, rs, ro], 4,
                                             [1, 32, 32, 1], backend)
    mm = g2lo.shape[0]
    p2 = torch.arange(mm, device=rlo.device)
    real = spad == 0
    key_new = ((g2lo != _shift_right_one(g2lo, 0))
               | (g2hi != _shift_right_one(g2hi, 0)))
    key_new[:1] = True
    key_end = real & _ends(key_new | ~real)
    o = widen(g2o)
    cum_t = torch.cumsum(o, 0)                            # all occurrences
    cum_b = torch.cumsum(torch.where(g2s > 0, o, 0), 0)   # side B's
    n_keys = key_end.sum()
    order = stable_partition(key_end)
    ct_end, cb_end = cum_t[order], cum_b[order]
    ct = ct_end - _shift_right_one(ct_end, 0)
    cb = cb_end - _shift_right_one(cb_end, 0)
    ca = ct - cb
    keep = (p2 < n_keys) & _qualifies(op, ca > 0, cb > 0)
    num = keep.sum()
    order2 = stable_partition(keep)
    valid = p2 < num
    klo, khi = g2lo[order][order2], g2hi[order][order2]
    return (torch.where(valid, klo, -1), torch.where(valid, khi, -1),
            narrow(torch.where(valid, ca[order2], 0)),
            narrow(torch.where(valid, cb[order2], 0)), num)


def distributed_set_op(akey: U64, bkey: U64, mesh, op: str = "union",
                       samples_per_dev: int = 128,
                       capacity_factor: float = 2.0,
                       capacity: int | None = None, backend: str = "radix"):
    """DISTINCT-semantics UNION / INTERSECT / EXCEPT over sharded u64 key
    columns (ops/setops.py semantics): local (key, side) dedup with exact
    multiplicities, tuples routed by key splitters so every key's verdict
    is local and exact. Returns (klo, khi, count_a, count_b, num,
    overflow), splitter-disjoint key ranges across shards."""
    if op not in _OPS:
        raise ValueError(f"op must be one of {_OPS}, got {op!r}")
    n_dev = mesh.n_dev
    n_local = akey.lo.shape[1] + bkey.lo.shape[1]
    capacity = max(_capacity(capacity, capacity_factor, n_local, n_dev), 16)
    klo, khi, side, occ, is_real, dest = _dset_dedup_route(
        mesh, akey.lo, akey.hi, bkey.lo, bkey.hi, n_dev=n_dev,
        samples_per_dev=samples_per_dev, backend=backend)
    recv, _, _, _, overflow = exchange(
        mesh, dest, [klo, khi, torch.where(is_real, side, 0),
                     torch.where(is_real, occ, 0)],
        [ONES, ONES, 0, 0], n_dev, capacity, backend)
    out = _stack([_dset_verdict(*(c[s] for c in recv), op, backend)
                  for s in range(klo.shape[0])])
    return (*out, overflow)


def distributed_set_op_numpy(a, b, mesh, op="union", **kw):
    """Host wrapper: result keys (ascending) + per-key (count_a, count_b)
    multiplicities over all shards."""
    ak, bk = shard_u64(a, mesh), shard_u64(b, mesh)
    kw = _auto_capacity(kw, mesh, plan_set_op_capacity, (ak, bk),
                        ("capacity",))
    res = distributed_set_op(ak, bk, mesh=mesh, op=op, **kw)
    _check_overflow(res[-1])
    lo, hi, ca, cb = _prefixes(mesh, res[:4], res[4])
    keys = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    return keys, ca, cb
