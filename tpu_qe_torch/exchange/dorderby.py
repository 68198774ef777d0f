"""Distributed multi-column ORDER BY over a mesh of shards: the port of
tpu_qe/exchange/dorderby.py.

The distributed_sort pattern over SQL's mixed-type, mixed-direction key
lists (ops/orderby.py): every key column contributes its order-preserving
u32 planes (DESC inverts a plane's bits, which reverses its order and
composes with routing), the global input position rides as the last
plane, and

1. lexicographic splitters are sampled over (key planes..., position)
   (shuffle.sample_splitters_multi): the unique position plane splits a
   hot key's rows across consecutive shards;
2. one two-tier exchange moves every table plane;
3. each shard sorts its received real rows by (key planes..., stability
   rank) and writes them to the front of its run, as wide as the most
   real rows a shard of the mesh received (the JAX run is the whole
   receive layout); the pad slots after them hold the all-ones key planes and
   position of the JAX run's pads and zero payloads. The JAX shard sorts
   its whole receive layout by (key planes..., position) with an
   unstable sort; among a shard's real rows the exchange's stability rank
   orders as the position does, so the rows come out the same.

Concatenating the shards' valid prefixes in mesh order is the globally
ordered table. Every sort is ``sort.planes.sort_planes`` (B1-B3 on the
card).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_qe_torch.bits import U64, widen
from tpu_qe_torch.exchange.dsort import _global_pos, sort_real_rows
from tpu_qe_torch.exchange.shuffle import (ONES, exchange, offdiag_demand,
                                           pow2_capacity,
                                           route_by_splitters_multi,
                                           sample_splitters_multi)
from tpu_qe_torch.ops.orderby import canon_by, key_planes, reconstruct_keys
from tpu_qe_torch.table import Table, column_from_numpy, column_to_numpy, \
    from_plane, plane


def _route(mesh, kp, n_dev, samples_per_dev, backend):
    """(gpos, dest): routing on (key planes..., global position)."""
    gpos = _global_pos(mesh, kp[0].shape[1], kp[0].device)
    planes = list(kp) + [gpos]
    sps = sample_splitters_multi(mesh, planes, n_dev, samples_per_dev,
                                 backend)
    return gpos, route_by_splitters_multi(planes, sps)


def _dob_shard(mesh, kp, payloads, *, n_dev, samples_per_dev, capacity,
               backend):
    """Shard body: route, exchange, sort the received rows. Returns (key
    planes, gpos, payloads, valid, overflow), (S, run) planes."""
    n_local = kp[0].shape[1]
    gpos, dest = _route(mesh, kp, n_dev, samples_per_dev, backend)
    cols = list(kp) + [gpos] + list(payloads)
    pads = [ONES] * (len(kp) + 1) + [0] * len(payloads)
    recv, flag, rank, counts, overflow = exchange(
        mesh, dest, cols, pads, n_dev, capacity, backend)
    m_stride = max(capacity, n_local)
    valid = counts.sum(1)
    skp, _, rest = sort_real_rows(
        flag, recv[:len(kp)], [ONES] * len(kp), rank,
        (n_dev * m_stride - 1).bit_length(), recv[len(kp):],
        [ONES] + [0] * len(payloads), max(int(mesh.pmax(valid).max()), 1),
        backend)
    return skp, rest[0], rest[1:], valid, overflow


def plan_order_by_capacity(table: Table, by, mesh,
                           samples_per_dev: int = 128,
                           backend: str = "radix") -> torch.Tensor:
    """Measured off-diagonal row demand of the ORDER BY exchange (routing
    on every key plane and the position), (S,) int64, the same on every
    shard. `table` holds (S, n_local) columns (shard_table)."""
    kp, _ = key_planes(table, canon_by(by))
    _, dest = _route(mesh, kp, mesh.n_dev, samples_per_dev, backend)
    return offdiag_demand(mesh, dest, mesh.n_dev)


def distributed_order_by(table: Table, by, mesh, samples_per_dev: int = 128,
                         capacity_factor: float = 2.0,
                         capacity: int | None = None,
                         backend: str = "radix"):
    """Multi-column ORDER BY over a sharded Table.

    table: columns of (S, n_local) rows (shard_table), keys as in
    ops.orderby.sort_by_multi. Returns (sorted_table, pos, valid,
    overflow): per-shard padded runs, (S, run) columns, whose first
    valid[s] ((S,) int64) rows are real; concatenating the valid prefixes
    in mesh order is the globally ordered table. `pos` (int64) is each
    row's global input position (the stability witness and restore
    handle); overflow ((S,) int64) is nonzero if an off-diagonal bucket
    exceeded its capacity.
    """
    spec = canon_by(by)
    kp, meta = key_planes(table, spec)
    n_dev = mesh.n_dev
    n_local = kp[0].shape[1]
    n = n_local * n_dev
    assert n < (1 << 32) - 1, n   # the pad position (all-ones) sorts last
    if capacity is None:
        capacity = int(np.ceil(capacity_factor * n_local / n_dev))
    capacity = max(capacity, 16)
    assert n_dev * max(capacity, n_local) < (1 << 31), (n_dev, capacity)
    key_names = {nm for nm, _ in spec}
    pay_names, payloads = [], []
    for nm in table:
        if nm in key_names:
            continue
        c = table[nm]
        pay_names.append(nm)
        payloads += [c.lo, c.hi] if isinstance(c, U64) else [plane(c)]
    skp, gpos, spay, valid, overflow = _dob_shard(
        mesh, kp, payloads, n_dev=n_dev, samples_per_dev=samples_per_dev,
        capacity=capacity, backend=backend)
    cols = reconstruct_keys(skp, meta)
    i = 0
    for nm in pay_names:
        c = table[nm]
        if isinstance(c, U64):
            cols[nm] = U64(spay[i], spay[i + 1])
            i += 2
        else:
            cols[nm] = from_plane(spay[i], c.dtype)
            i += 1
    return (Table({nm: cols[nm] for nm in table}), widen(gpos), valid,
            overflow)


def shard_table(cols_np: dict, mesh) -> Table:
    """Global numpy columns -> a Table of this process's (S, n_local)
    shards on the mesh's device."""
    def shard(c):
        if isinstance(c, U64):
            return U64(mesh.shard(c.lo), mesh.shard(c.hi))
        return from_plane(mesh.shard(plane(c)), c.dtype)
    return Table({nm: shard(column_from_numpy(v, "cpu"))
                  for nm, v in cols_np.items()})


def distributed_order_by_numpy(cols_np: dict, by, mesh, **kw):
    """Host wrapper: shard a numpy column dict, run, concatenate the
    shards' valid prefixes (the globally ordered table) and the position
    witness (u32). capacity_factor="auto" plans the demand first. Under a
    GroupMesh every rank passes the global input and gets the whole
    answer."""
    t = shard_table(cols_np, mesh)
    if kw.get("capacity_factor") == "auto":
        kw = dict(kw)
        del kw["capacity_factor"]
        if mesh.n_dev > 1:
            demand = int(plan_order_by_capacity(
                t, by, mesh, samples_per_dev=kw.get("samples_per_dev", 128),
                backend=kw.get("backend", "radix")).max())
            kw["capacity"] = pow2_capacity(demand)
    st, pos, valid, overflow = distributed_order_by(t, by, mesh, **kw)
    if int(overflow.max()):
        raise RuntimeError("exchange capacity overflow; raise "
                           "capacity_factor")
    valid = mesh.collect(valid).cpu().numpy()
    m = int(valid.max()) if valid.size else 0   # read back no padding

    def prefixes(c):
        if isinstance(c, U64):
            a = U64(mesh.collect(c.lo[:, :m]),
                    mesh.collect(c.hi[:, :m])).to_numpy()
        else:
            a = column_to_numpy(from_plane(mesh.collect(plane(c)[:, :m]),
                                           c.dtype))
        return np.concatenate([a[d, :int(v)] for d, v in enumerate(valid)])

    out = {nm: prefixes(st[nm]) for nm in st}
    posr = mesh.collect(pos[:, :m]).cpu().numpy()
    out_pos = np.concatenate([posr[d, :int(v)] for d, v in enumerate(valid)])
    return out, out_pos.astype(np.uint32)
