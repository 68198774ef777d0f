"""Distributed sort over a mesh of shards: the port of
tpu_qe/exchange/dsort.py.

Splitter-based sample sort (skew-robust):

1.  every shard draws a fixed oversample of its (key, global position)
    rows; an all_gather and a small sort give global splitters at the
    D-quantiles, so skewed keys (a single hot key too) still balance;
2.  rows are routed to ``dest = #(splitters < row)`` and exchanged with
    the padded fixed-size all_to_all of exchange/shuffle.py;
3.  each shard sorts what it received by (key, stability rank).

Each shard's sorted run, concatenated in mesh order, is the global stable
order. Where the JAX shard sorts its whole receive layout with the pad
flag packed over the rank, the port sorts only the received real rows,
all shards' in one stable sort with the shard as the most significant key,
and writes them to the front of each run: the pad sentinels (all-ones
key, payload 0) would have sorted after them, so every run is the JAX
run, its padded tail included. ``overlap=k`` splits the exchange into k
sub-exchanges whose received chunks are sorted alone and combined by a
bitonic merge tree (sort/merge.py): the valid prefix is bit-identical to
overlap=1.

Every sort of this path (samples, partitions, the local sorts) goes
through ``sort.planes.sort_planes`` (B1-B3 on the card).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_qe_torch.bits import U64, as_i32, narrow, widen
from tpu_qe_torch.exchange.mesh import make_mesh  # noqa: F401
from tpu_qe_torch.exchange.shuffle import (ONES, exchange, i32,
                                           offdiag_demand, pow2_capacity,
                                           route_by_splitters_pos,
                                           sample_splitters_pos)
from tpu_qe_torch.sort.merge import merge_tree
from tpu_qe_torch.sort.planes import argsort_planes, sort_planes


class DistSortResult(NamedTuple):
    """Padded per-shard sorted runs, (S, run length) planes.

    The run length depends on the path: D * capacity + n_local for the
    monolithic exchange, k * next_pow2(D * capacity + n_local / k) with
    overlap=k, n_local on a mesh of one. Use ``valid`` ((S,) int64): the
    first valid[s] rows of shard s's run are its real rows, sorted.
    """

    key: U64
    payloads: tuple
    valid: torch.Tensor


def _global_pos(mesh, n_local: int, device) -> torch.Tensor:
    """(S, n_local) int32 plane of each row's u32 global position."""
    return narrow(mesh.ranks()[:, None] * n_local
                  + torch.arange(n_local, device=device))


def _route(mesh, lo, hi, n_dev, samples_per_dev, backend):
    gpos = _global_pos(mesh, lo.shape[1], lo.device)
    sp = sample_splitters_pos(mesh, lo, hi, gpos, n_dev, samples_per_dev,
                              backend)
    return route_by_splitters_pos(lo, hi, gpos, *sp)


def sort_real_rows(flag, keys, key_fills, rank, rank_bits: int, payloads,
                   pay_fills, run: int, backend, with_rank: bool = False):
    """Each shard's real received rows (flag 0) sorted by (keys..., rank)
    at the front of a run of `run` rows; the rest are pad rows.

    keys: (S, L) u32 planes, most significant first; rank: (S, L) plane of
    the exchange's stability rank, below 2^rank_bits. Returns (sorted key
    planes, rank or None, payloads), (S, run) each; the pad slots hold
    key_fills, all-ones ranks and pay_fills. One stable sort of every
    shard's real rows, the shard as the most significant key. The rank
    is unique among a shard's real rows, so rows that tie on every key
    plane come out as an unstable sort by (keys..., rank) would give them.
    """
    shards, width = flag.shape
    dev = flag.device
    src = (flag.reshape(-1) == 0).nonzero().squeeze(1)   # (shard, slot) order
    shard = src // width
    kp = [k.reshape(-1)[src] for k in keys] + [rank.reshape(-1)[src]]
    bits = [32] * len(keys) + [rank_bits]
    if shards > 1:
        kp, bits = [shard.to(torch.int32)] + kp, [
            max((shards - 1).bit_length(), 1)] + bits
    skeys, perm = argsort_planes(kp, bits, backend)
    s_sorted = skeys.pop(0).to(torch.int64) if shards > 1 else shard
    # src ascends, so does its shard: each shard's first real row
    start = torch.searchsorted(shard, torch.arange(shards, device=dev))
    dst = s_sorted * run + torch.arange(src.shape[0], device=dev) - start[
        s_sorted]
    src = src[perm]

    def place(values, fill):
        out = torch.full((shards * run,), i32(fill), dtype=torch.int32,
                         device=dev)
        out[dst] = values
        return out.reshape(shards, run)

    return ([place(k, f) for k, f in zip(skeys, key_fills)],
            place(skeys[-1], ONES) if with_rank else None,
            [place(p.reshape(-1)[src], f) for p, f in zip(payloads,
                                                          pay_fills)])


def _sort_received(recv, flag, rank, rank_bits: int, run: int, backend,
                   with_rank: bool = True):
    """Each shard's real received rows sorted by (hi, lo, rank) at the
    front of a run of `run` rows (sort_real_rows).

    recv = [lo, hi, *payloads], (S, L) planes. Returns (lo, hi, rank,
    payloads), (S, run) each (rank None unless with_rank); the pad slots
    hold lo = hi = rank = all-ones and payload 0.
    """
    lo, hi, *pay = recv
    (shi, slo), srank, spay = sort_real_rows(
        flag, [hi, lo], [ONES, ONES], rank, rank_bits, pay, [0] * len(pay),
        run, backend, with_rank)
    return slo, shi, srank, spay


def _dsort_shard(mesh, lo, hi, *payloads, n_dev: int, samples_per_dev: int,
                 capacity: int, backend: str):
    """Per-shard body of the monolithic exchange."""
    dest = _route(mesh, lo, hi, n_dev, samples_per_dev, backend)
    cols = [lo, hi] + list(payloads)
    pads = [ONES, ONES] + [0] * len(payloads)
    recv, flag, rank, recv_counts, overflow = exchange(
        mesh, dest, cols, pads, n_dev, capacity, backend)
    m_stride = max(capacity, lo.shape[1])
    out_lo, out_hi, _, out_pay = _sort_received(
        recv, flag, rank, (n_dev * m_stride - 1).bit_length(),
        flag.shape[1], backend, with_rank=False)
    return out_lo, out_hi, out_pay, recv_counts.sum(1), overflow


def _dsort_shard_overlap(mesh, lo, hi, *payloads, n_dev: int,
                         samples_per_dev: int, capacity: int, k: int,
                         backend: str):
    """Overlapped body: k sub-exchanges of contiguous row slices (in
    original order, so each chunk's buckets are ~1/k of the full ones),
    each received chunk sorted alone and padded to a power of two, then a
    bitonic merge tree. Chunk j's rows from a source precede chunk j+1's,
    so the rank is globalized as (source, chunk, order within)."""
    n_local = lo.shape[1]
    assert n_local % k == 0, (n_local, k)
    w = n_local // k
    dest = _route(mesh, lo, hi, n_dev, samples_per_dev, backend)
    cols = [lo, hi] + list(payloads)
    pads = [ONES, ONES] + [0] * len(payloads)
    m_stride = max(capacity, w)       # exchange()'s stride for a chunk
    l0 = n_dev * capacity + w
    l_pow2 = 1 << (max(l0, 2) - 1).bit_length()
    rank_bits = (n_dev * m_stride * k - 1).bit_length()
    runs = []
    valid = overflow = 0
    for j in range(k):
        sl = slice(j * w, (j + 1) * w)
        recv, flag, rank, counts_j, ovf_j = exchange(
            mesh, dest[:, sl], [c[:, sl] for c in cols], pads, n_dev,
            capacity, backend)
        r = widen(rank)
        grank = narrow((r // m_stride) * (m_stride * k) + j * m_stride
                       + r % m_stride)
        # pads (all-ones key and rank, payload 0) keep the run sorted
        s_lo, s_hi, s_rank, s_pay = _sort_received(
            recv, flag, grank, rank_bits, l_pow2, backend)
        runs.append([s_hi, s_lo, s_rank] + s_pay)
        valid = valid + counts_j.sum(1)
        overflow = overflow | ovf_j
    res = merge_tree(runs)
    return res[1], res[0], res[3:], valid, overflow


def _plan_shard(mesh, lo, hi, *, n_dev, samples_per_dev, backend):
    """Planning pass: route exactly like the sort, return the largest
    off-diagonal bucket ((S,) int64)."""
    dest = _route(mesh, lo, hi, n_dev, samples_per_dev, backend)
    return offdiag_demand(mesh, dest, n_dev)


def plan_sort_capacity(key: U64, mesh, samples_per_dev: int = 128,
                       backend: str = "radix") -> torch.Tensor:
    """Measured off-diagonal exchange demand of distributed_sort, (S,)
    int64 (the same on every shard): pass its max (rounded up, e.g. by
    pow2_capacity) as `capacity` for a demand-sized receive layout."""
    return _plan_shard(mesh, key.lo, key.hi, n_dev=mesh.n_dev,
                       samples_per_dev=samples_per_dev, backend=backend)


def distributed_sort(key: U64, *payloads: torch.Tensor, mesh,
                     samples_per_dev: int = 128,
                     capacity_factor: float = 2.0,
                     capacity: int | None = None, overlap: int = 1,
                     backend: str = "radix"):
    """Stable sort of sharded u64 keys (+ 32-bit payload planes).

    Args:
      key: U64 of (S, n_local) int32 planes (``mesh.shard`` of the global
        keys); payloads likewise.
      capacity: explicit per-(src, dst) off-diagonal bucket capacity (e.g.
        from plan_sort_capacity); overrides capacity_factor. With
        overlap=k it applies per sub-exchange.
      overlap: number of sub-exchanges (a power of two dividing the shard
        size); the valid prefixes are bit-identical to overlap=1.
    Returns:
      (DistSortResult, overflow): shard s's run holds the s-th quantile of
      the global key order in its first valid[s] rows; overflow ((S,)
      int64) is nonzero if an off-diagonal send bucket exceeded capacity.
    """
    n_dev = mesh.n_dev
    shards, n_local = key.lo.shape
    n = n_local * n_dev
    assert n < (1 << 32), n          # global positions travel as u32
    dev = key.lo.device
    pay = [p.view(torch.int32) if p.dtype != torch.int32 else p
           for p in payloads]
    if n_dev == 1:
        # degenerate mesh: one local stable sort, no exchange
        res = sort_planes([key.hi[0], key.lo[0]] + [p[0] for p in pay], 2,
                          backend=backend)
        return (DistSortResult(U64(res[1][None], res[0][None]),
                               tuple(p[None] for p in res[2:]),
                               torch.full((1,), n, device=dev)),
                torch.zeros(1, dtype=torch.int64, device=dev))
    assert overlap >= 1 and (overlap & (overlap - 1)) == 0, overlap
    if overlap > 1:
        assert n_local % overlap == 0, (n_local, overlap)
        w = n_local // overlap
        if capacity is None:
            capacity = int(np.ceil(capacity_factor * w / n_dev))
        capacity = max(capacity, 16)
        # the merge key is the global rank, below the pad bit
        assert n_dev * max(capacity, w) * overlap < (1 << 31), (
            n_dev, capacity, overlap)
        out = _dsort_shard_overlap(mesh, key.lo, key.hi, *pay, n_dev=n_dev,
                                   samples_per_dev=samples_per_dev,
                                   capacity=capacity, k=overlap,
                                   backend=backend)
    else:
        if capacity is None:
            capacity = int(np.ceil(capacity_factor * n_local / n_dev))
        capacity = max(capacity, 16)
        # the stability rank stays below the pad bit
        assert n_dev * max(capacity, n_local) < (1 << 31), (n_dev, capacity)
        out = _dsort_shard(mesh, key.lo, key.hi, *pay, n_dev=n_dev,
                           samples_per_dev=samples_per_dev,
                           capacity=capacity, backend=backend)
    out_lo, out_hi, out_pay, valid, overflow = out
    return DistSortResult(U64(out_lo, out_hi), tuple(out_pay),
                          valid), overflow


def auto_capacity(key: U64, mesh, samples_per_dev: int = 128,
                  slack: float = 1.05, backend: str = "radix") -> int:
    """Demand-sized off-diagonal capacity for distributed_sort: run the
    planning pass, read back the demand, size it by pow2_capacity."""
    demand = int(plan_sort_capacity(key, mesh, samples_per_dev,
                                    backend).max())
    return pow2_capacity(demand, slack)


def shard_u64(keys: np.ndarray, mesh) -> U64:
    """Global numpy u64 keys -> this process's (S, n_local) U64 shards."""
    k = U64.from_numpy(keys, "cpu")
    return U64(mesh.shard(k.lo), mesh.shard(k.hi))


def shard_u32(values: np.ndarray, mesh) -> torch.Tensor:
    """Global numpy 32-bit values -> (S, n_local) int32 planes of their
    bit patterns (u32, i32 and f32 arrays keep their bits)."""
    v = np.asarray(values)
    bits = (v.view(np.int32) if v.dtype in (np.float32, np.int32)
            else as_i32(v))
    return mesh.shard(torch.from_numpy(np.ascontiguousarray(bits)))


def shard_column(values: np.ndarray, mesh):
    """A global numpy column -> this process's (S, n_local) shards: U64
    for uint64, else a uint32 / int32 / float32 tensor."""
    v = np.asarray(values)
    if v.dtype == np.uint64:
        return shard_u64(v, mesh)
    dtype = {np.dtype(np.uint32): torch.uint32, np.dtype(np.int32):
             torch.int32, np.dtype(np.float32): torch.float32}[v.dtype]
    p = shard_u32(v, mesh)
    return p if dtype == torch.int32 else p.view(dtype)


def collect_u32(x: torch.Tensor, mesh) -> np.ndarray:
    """(S, m) planes -> the whole mesh's (D, m) u32 numpy array."""
    return mesh.collect(x).cpu().numpy().view(np.uint32)


def distributed_sort_numpy(keys: np.ndarray, payload: np.ndarray | None,
                           mesh, **kw):
    """Host-side wrapper: shard, sort, collect, compact (tests and benches).

    Under a GroupMesh every rank passes the global input, sorts its own
    shard and gets the whole answer back. capacity_factor="auto" plans
    the exchange first (plan_sort_capacity).
    """
    n_dev = mesh.n_dev
    assert len(keys) % n_dev == 0, (len(keys), n_dev)
    key = shard_u64(keys, mesh)
    payloads = () if payload is None else (shard_u32(payload, mesh),)
    if kw.get("capacity_factor") == "auto":
        kw = dict(kw)
        del kw["capacity_factor"]
        if n_dev > 1:
            kw["capacity"] = auto_capacity(
                key, mesh, samples_per_dev=kw.get("samples_per_dev", 128),
                backend=kw.get("backend", "radix"))
    res, overflow = distributed_sort(key, *payloads, mesh=mesh, **kw)
    if int(overflow.max()):
        raise RuntimeError("exchange capacity overflow; raise capacity_factor")
    lo = collect_u32(res.key.lo, mesh)
    hi = collect_u32(res.key.hi, mesh)
    valid = mesh.collect(res.valid).cpu().numpy()
    p = None if payload is None else collect_u32(res.payloads[0], mesh)
    out_keys, out_pay = [], []
    for d in range(n_dev):
        v = int(valid[d])
        out_keys.append(lo[d, :v].astype(np.uint64)
                        | (hi[d, :v].astype(np.uint64) << np.uint64(32)))
        if p is not None:
            out_pay.append(p[d, :v])
    keys_out = np.concatenate(out_keys)
    if payload is None:
        return keys_out
    return keys_out, np.concatenate(out_pay)
