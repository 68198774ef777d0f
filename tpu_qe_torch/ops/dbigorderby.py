"""Distributed out-of-core multi-column ORDER BY over a mesh of shards: the
port of tpu_qe/ops/dbigorderby.py.

ops/bigorderby.py's external sample sort over transformed key planes (a
DESC as inverted bits, b ASC as sign-flipped bits), composed with the mesh
as sort/dbigsort.py composes the sort, on the (t1, t2, t3, index) order:

  phase A   every shard forms R sorted runs of its rows (transformed
            planes, index, payload; all local shards' indices in one
            launch sequence);
  phase B   4-plane splitters at the (D * B)-quantiles of strided samples
            of every run (all_gathered, sorted once) and each run's exact
            boundaries by a lexicographic binary search
            (ops/bigwindow.py::_searchsorted_multi); the plan crosses to
            the host once;
  phase X   the segment exchange of sort/dbigsort.py;
  phase C   per bucket round, every shard: one sort of its received
            segments and the checks on the device: lexicographic
            sortedness with the index tie-break, every row's planes and
            payload re-derived from its index, the count, the exact u64
            index sum (summed on the host into the n(n-1)/2 permutation
            certificate) and the first and last (t1, t2, t3), chained on
            the host in global bucket order.

Every sort is ``sort_planes`` (B1-B3 on the card) and stable, by (t1, t2,
t3) with the index riding along: a run is made in index order, and a
bucket's segments are concatenated in (source, run) order, which is
global index order, so rows of equal keys stand in index order, the order
the reference's fourth key (the index) gives; its sample sort ties only
on equal rows. ORDER BY has no cross-bucket recurrence, so the rounds
queue with no read-back until the end.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_qe_torch.bits import U32_MASK, narrow, widen
from tpu_qe_torch.exchange.shuffle import ONES
from tpu_qe_torch.ops.bigorderby import (N_COLS, N_PLANES, BigOrderByResult,
                                         _cols_of, order_by_big)
from tpu_qe_torch.ops.bigwindow import _searchsorted_multi
from tpu_qe_torch.sort.bigsort import _build_seconds, _fence
from tpu_qe_torch.sort.dbigsort import (bucket_cols, exchange_runs,
                                        run_index, segment_plan,
                                        sort_shards)
from tpu_qe_torch.sort.driver import signed_key
from tpu_qe_torch.sort.planes import sort_planes
from tpu_qe_torch.utils.profiling import span

# scalars per shard and bucket round: s_ok, h_ok, cnt, isum_lo, isum_hi,
# first (t1, t2, t3), last (t1, t2, t3)
N_CHECK = 10
_FILLS = (ONES,) * 4 + (0,)


def _runs(mesh, n_local, n_runs, run_size, a_card, seed):
    """Phase A: per run, (S, run_size) planes (t1, t2, t3, idx, pay),
    every local shard's run sorted."""
    runs = []
    for r in range(n_runs):
        idx = narrow(run_index(mesh, n_local, r, run_size, mesh.device))
        t1, t2, t3, pay = _cols_of(idx, a_card, seed)
        runs.append(sort_shards([t1, t2, t3, idx, pay], N_PLANES))
        del idx, t1, t2, t3, pay
    return runs


def _plan(mesh, runs, n_buckets_total: int, per_run: int) -> np.ndarray:
    """Phase B: (t1, t2, t3, index) splitters at the (D * B)-quantiles and
    each run's exact boundaries: the whole mesh's (D, R, D * B - 1) int64
    plan on the host."""
    run_size = runs[0][0].shape[1]
    dev = runs[0][0].device
    sel = torch.arange(per_run, device=dev) * max(run_size // per_run,
                                                  1) % run_size
    samples = [torch.cat([run[j][:, sel] for run in runs], 1)
               for j in range(4)]
    g = sort_planes([mesh.all_gather(s)[0] for s in samples], 4)
    total = g[0].shape[0]
    q = torch.arange(1, n_buckets_total, device=dev) * total \
        // n_buckets_total
    sp = [p[q] for p in g]
    bounds = torch.stack([torch.stack([
        _searchsorted_multi([run[j][i] for j in range(4)], sp)
        for run in runs]) for i in range(runs[0][0].shape[0])])
    return mesh.collect(bounds).cpu().numpy()


def _bucket(cols, count: int, a_card: int, seed: int):
    """Phase C for one shard and bucket: sort, check; (N_CHECK + 1,) int64
    scalars of u32 values and the sorted planes."""
    st1, st2, st3, sidx, spay = sort_planes(cols, N_PLANES)
    m = st1.shape[0]
    dev = st1.device
    valid = torch.arange(m, device=dev) < count
    # (t1, t2, t3, idx) strictly increasing over the valid rows, unsigned
    k1, k2 = signed_key(st2, st1), signed_key(sidx, st3)
    lt = (k1[:-1] < k1[1:]) | ((k1[:-1] == k1[1:]) & (k2[:-1] < k2[1:]))
    s_ok = (lt | ~valid[1:]).all()
    w1, w2, w3, wpay = _cols_of(sidx, a_card, seed)
    h_ok = (~valid | ((st1 == w1) & (st2 == w2) & (st3 == w3)
                      & (spay == wpay))).all()
    isum = torch.where(valid, widen(sidx), 0).sum()
    li = max(count, 1) - 1
    out = torch.cat([torch.stack([s_ok, h_ok]).to(torch.int64),
                     torch.full((1,), count, device=dev),
                     torch.stack([isum & U32_MASK, (isum >> 32) & U32_MASK]),
                     widen(torch.stack([st1[0], st2[0], st3[0],
                                        st1[li], st2[li], st3[li]]))])
    return out, (st1, st2, st3, sidx, spay)


def order_by_big_distributed(n: int, mesh, a_card: int | None = None,
                             run_size: int = 1 << 26,
                             buckets_per_dev: int | None = None,
                             seed: int = 7, samples_per_run: int = 4096,
                             verbose: bool = False, collect: bool = False,
                             force_composed: bool = False,
                             stats: dict | None = None):
    """Distributed out-of-core ORDER BY a DESC, b ASC over `mesh` (module
    docstring), on the mesh's device.

    n must be a multiple of D * run_size and < 2^31. At D == 1 the call
    delegates to order_by_big unless force_composed. Returns
    BigOrderByResult (+ the ordered columns on the host with
    collect=True). stats (a dict) receives "shard_rows", the rows each
    shard holds after the exchange (composed path only).
    """
    n_dev = mesh.n_dev
    dev = mesh.device
    if a_card is None:
        a_card = max(n // 256, 1)
    if n_dev == 1 and not force_composed:
        return order_by_big(n, a_card=a_card, run_size=run_size,
                            n_buckets=buckets_per_dev, seed=seed,
                            samples_per_run=samples_per_run,
                            verbose=verbose, collect=collect, device=dev)
    assert n % (n_dev * run_size) == 0, \
        (f"n must be a multiple of devices*run_size "
         f"(n={n}, devices={n_dev}, run_size={run_size})")
    assert n < (1 << 31), n
    n_local = n // n_dev
    n_runs = n_local // run_size
    if buckets_per_dev is None:
        buckets_per_dev = max(1, int(np.ceil(n_local / (1 << 26))))
    n_b = buckets_per_dev
    S = n_dev * n_b
    per_run = min(samples_per_run, run_size)
    ranks = mesh.ranks().tolist()
    compile_s = _build_seconds(dev)

    t0 = _fence(dev)
    with span("dbigorderby phase A: sorted runs"):
        runs = _runs(mesh, n_local, n_runs, run_size, a_card, seed)
    t_a = _fence(dev) - t0

    t0 = _fence(dev)
    with span("dbigorderby phase B: plan"):
        bounds = _plan(mesh, runs, S, per_run)
    t_b = _fence(dev) - t0
    pos, blk_start, blk_size, seg_size, cap_blk, cap_off = segment_plan(
        bounds, run_size, n_b)
    if verbose:
        print(f"dbigorderby: D={n_dev} R={n_runs} B={n_b} run={run_size} "
              f"cap_blk={cap_blk} cap_off={cap_off} "
              f"largest segment {int(seg_size.max())}")

    t0 = _fence(dev)
    with span("dbigorderby phase X: segment exchange"):
        blocks = exchange_runs(mesh, runs, blk_start, blk_size, cap_blk,
                               cap_off, _FILLS)
    del runs
    t_x = _fence(dev) - t0

    t0 = _fence(dev)
    pending, collected = [], {}
    with span("dbigorderby phase C: bucket rounds"):
        for b in range(n_b):
            outs = []
            for i, t in enumerate(ranks):
                g = t * n_b + b
                cols, count = bucket_cols(blocks, i,
                                          pos[:, :, g] - blk_start[:, :, t],
                                          seg_size[:, :, g], _FILLS)
                out, srt = _bucket(cols, count, a_card, seed)
                outs.append(out)
                if collect:
                    collected[(b, i)] = [c[:count] for c in srt]
                del cols, srt
            pending.append(torch.stack(outs))
        scal = mesh.collect(torch.stack(pending, 1)).cpu().numpy()
    t_c = _fence(dev) - t0                       # scal: (D, B, N_CHECK + 1)

    s_ok, h_ok, cnt = scal[..., 0], scal[..., 1], scal[..., 2]
    isum = int((scal[..., 3] | (scal[..., 4] << 32)).sum())
    boundary_ok = True
    prev_last = None
    for t in range(n_dev):          # global bucket order g = t * B + b
        for b in range(n_b):
            if cnt[t, b] == 0:
                continue
            first = tuple(int(x) for x in scal[t, b, 5:8])
            if prev_last is not None:
                boundary_ok &= prev_last <= first
            prev_last = tuple(int(x) for x in scal[t, b, 8:11])

    dt = t_a + t_b + t_x + t_c
    res = BigOrderByResult(
        n=n, a_card=a_card, seconds=dt, rows_per_s=n / dt,
        sorted_ok=bool(s_ok.all()), hash_ok=bool(h_ok.all()),
        boundary_ok=boundary_ok, count_ok=int(cnt.sum()) == n,
        perm_ok=isum == n * (n - 1) // 2,
        phase_a_s=t_a, phase_c_s=t_c, compile_s=compile_s)
    if stats is not None:
        stats["shard_rows"] = [int(x) for x in cnt.sum(1)]
    if verbose:
        print(f"dbigorderby phases: A={t_a:.2f}s B={t_b:.2f}s "
              f"X={t_x:.2f}s C={t_c:.2f}s total={dt:.2f}s")
    if collect:
        # every shard's rows of each bucket, in global bucket order
        full = {}
        for b in range(n_b):
            width = max(int(cnt[:, b].max()), 1)
            for j in range(N_COLS):
                mine = [torch.cat([collected[(b, i)][j], torch.zeros(
                    width - int(cnt[r, b]), dtype=torch.int32, device=dev)])
                    for i, r in enumerate(ranks)]
                full[(b, j)] = mesh.collect(torch.stack(mine)).cpu(
                ).numpy().view(np.uint32)
        cols = [[full[(b, j)][t, :int(cnt[t, b])] for t in range(n_dev)
                 for b in range(n_b)] for j in range(N_COLS)]
        t1, t2, t3, ridx, pay = (np.concatenate(c) for c in cols)
        a = ((~t2).astype(np.uint64)
             | ((~t1).astype(np.uint64) << np.uint64(32)))
        bcol = (t3 ^ np.uint32(0x80000000)).view(np.int32)
        return res, {"a": a, "b": bcol, "idx": ridx, "pay": pay}
    return res
