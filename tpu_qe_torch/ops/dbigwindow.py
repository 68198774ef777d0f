"""Distributed out-of-core window functions over a mesh of shards: the port
of tpu_qe/ops/dbigwindow.py.

Data larger than one shard's memory, windowed across the mesh, from
three pieces:

  phase A/B/X  sort/dbigsort.py's machinery on the window order: per
               shard R runs sorted by (key, order, index) (all local
               shards' indices in one launch sequence), one splitter plan
               on the same composite (4-plane quantiles, then the
               lexicographic binary search of ops/bigwindow.py), so a hot
               partition splits across buckets and shards, and the segment
               exchange of 5 columns;
  phase P      every shard's incoming carry, before any window is
               computed: each shard summarises its received blocks in 14
               numbers (first and last rows, and over the rows of its last
               partition key: the count, the rank below the last order,
               the exact u64 sum; all masked reductions), the summaries
               are all_gathered, and the D-step chain of
               exchange/dwindow.py gives each shard the carry of the
               partition that runs into it. The bucket rounds then run
               on every shard at once;
  phase C      per bucket round, every shard: its segments, one sort, and
               ops/bigwindow.py's window_core (window planes, the carry
               patch, construction-exact checks: composite sortedness,
               closed-form hashes, every window column re-derived by its
               sequential recurrence seamed against the carry). Carries
               chain across rounds as device tensors, read back once.

The function set is window_big's: row_number, rank, the exact u64 running
sum and lag. The D-step chain is work the JAX package repeats on every
device after its all_gather; on a LocalMesh the port runs it once, on a
GroupMesh every rank runs it. Every sort is ``sort_planes`` (B1-B3 on the
card) and stable, by (key, order) with the index riding along: runs are
made in index order and a bucket's segments are concatenated in (source,
run) order, global index order, so rows of equal (key, order) stand in
index order, the reference's fourth key; its sample sort ties only on
equal rows. The summary's first and last rows are a minimum and a
maximum over the blocks' edge rows, where the reference sorts them.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_qe_torch.bits import SIGN_BIT, U32_MASK, narrow, widen
from tpu_qe_torch.exchange.shuffle import ONES
from tpu_qe_torch.ops.bigwindow import (BigWindowResult, _key_of, _ord_of,
                                        _searchsorted_multi, _val_of,
                                        window_big, window_core)
from tpu_qe_torch.sort.bigsort import _build_seconds, _fence
from tpu_qe_torch.sort.dbigsort import (bucket_cols, exchange_runs,
                                        run_index, segment_plan,
                                        sort_shards)
from tpu_qe_torch.sort.driver import signed_key
from tpu_qe_torch.sort.planes import sort_planes
from tpu_qe_torch.utils.profiling import span

_FILLS = (ONES,) * 4 + (0,)
_I64_MIN, _I64_MAX = torch.iinfo(torch.int64).min, torch.iinfo(
    torch.int64).max


def _runs(mesh, n_local, n_runs, run_size, partitions, seed):
    """Phase A: per run, (S, run_size) planes (lo, hi, o, idx, v), every
    local shard's run sorted by (key, order, index)."""
    runs = []
    for r in range(n_runs):
        idx = narrow(run_index(mesh, n_local, r, run_size, mesh.device))
        key = _key_of(idx, partitions, seed)
        o, v = _ord_of(idx, seed), _val_of(idx, seed)
        shi, slo, so, sidx, sv = sort_shards([key.hi, key.lo, o, idx, v], 3)
        runs.append([slo, shi, so, sidx, sv])
        del idx, key, o, v
    return runs


def _plan(mesh, runs, n_buckets_total: int, per_run: int) -> np.ndarray:
    """Phase B: (key, order, index) splitters at the (D * B)-quantiles and
    each run's exact boundaries: the whole mesh's (D, R, D * B - 1) int64
    plan on the host."""
    run_size = runs[0][0].shape[1]
    dev = runs[0][0].device
    sel = torch.arange(per_run, device=dev) * max(run_size // per_run,
                                                  1) % run_size
    planes = (1, 0, 2, 3)                  # hi, lo, o, idx
    samples = [torch.cat([run[j][:, sel] for run in runs], 1)
               for j in planes]
    g = sort_planes([mesh.all_gather(s)[0] for s in samples], 4)
    total = g[0].shape[0]
    q = torch.arange(1, n_buckets_total, device=dev) * total \
        // n_buckets_total
    sp = [p[q] for p in g]
    bounds = torch.stack([torch.stack([
        _searchsorted_multi([run[j][i] for j in planes], sp)
        for run in runs]) for i in range(runs[0][0].shape[0])])
    return mesh.collect(bounds).cpu().numpy()


def _edge(blocks, sizes, last: bool):
    """Each local shard's last (largest) or first (smallest) received row
    by (key, order, index): (lo, hi, o, v) as (S,) int64 u32 values. Only
    the first and last rows of every (run, source) block can be it.
    sizes: (S, R, D) int64 rows of each block."""
    cand = [[] for _ in range(5)]
    for r, cols in enumerate(blocks):
        at = torch.clamp(sizes[:, r] - 1, min=0) if last else \
            torch.zeros_like(sizes[:, r])
        for c in range(5):
            cand[c].append(cols[c].gather(2, at[:, :, None])[:, :, 0])
    lo, hi, o, idx, v = (torch.cat(c, 1) for c in cand)      # (S, R * D)
    ok = (sizes > 0).reshape(sizes.shape[0], -1)
    k1, k2 = signed_key(lo, hi), signed_key(idx, o)
    pick, red = (torch.amax, _I64_MIN) if last else (torch.amin, _I64_MAX)
    k1 = torch.where(ok, k1, red)
    top = pick(k1, 1, keepdim=True)
    k2 = torch.where(ok & (k1 == top), k2, red)
    j = (k2 == pick(k2, 1, keepdim=True)).to(torch.int32).argmax(
        1, keepdim=True)
    return tuple(widen(x.gather(1, j)[:, 0]) for x in (lo, hi, o, v))


def _summaries(blocks, sizes):
    """Phase P's per-shard summary, (S, 14) int64 of u32 values: nv, first
    (key lo, key hi, order), last (key lo, key hi, order), whole shard in
    one partition, and in one (partition, order) run, then over the rows
    of the last key: count, rank of the last order, exact sum (lo, hi),
    and the last value."""
    fk_lo, fk_hi, fo, _ = _edge(blocks, sizes, last=False)
    lk_lo, lk_hi, lo_last, lastv = _edge(blocks, sizes, last=True)
    shards = sizes.shape[0]
    dev = sizes.device
    cnt = torch.zeros(shards, dtype=torch.int64, device=dev)
    rank_below = torch.zeros_like(cnt)
    tail = torch.zeros_like(cnt)
    # the last row's words as int32 planes (orders compared unsigned)
    k_lo, k_hi = narrow(lk_lo)[:, None, None], narrow(lk_hi)[:, None, None]
    k_o = (narrow(lo_last) ^ SIGN_BIT)[:, None, None]
    for r, (lo, hi, o, _idx, v) in enumerate(blocks):
        valid = (torch.arange(lo.shape[2], device=dev)
                 < sizes[:, r, :, None])
        eq = valid & (lo == k_lo) & (hi == k_hi)
        del valid
        cnt += eq.sum((1, 2))
        rank_below += (eq & ((o ^ SIGN_BIT) < k_o)).sum((1, 2))
        tail += (widen(v) * eq).sum((1, 2))                 # < 2^63
        del eq
    tps = (fk_lo == lk_lo) & (fk_hi == lk_hi)
    trs = tps & (fo == lo_last)
    return torch.stack([sizes.sum((1, 2)), fk_lo, fk_hi, fo, lk_lo, lk_hi,
                        lo_last, tps.to(torch.int64), trs.to(torch.int64),
                        cnt, rank_below + 1, tail & U32_MASK,
                        (tail >> 32) & U32_MASK, lastv], 1)


def _carry_chain(g: torch.Tensor) -> torch.Tensor:
    """The D-step chain over the gathered (D, 14) summaries: every shard's
    incoming carry, (D, N_CARRY) int64 of u32 values (window_core's
    layout: have, last key lo / hi, last order, count, rank, sum lo / hi,
    last value)."""
    zero = g.new_zeros(())
    have = plk_lo = plk_hi = plord = zero
    c_cnt = c_rank = c_slo = c_shi = c_lv = zero
    rec = []
    for e in range(g.shape[0]):
        (nv, fkl, fkh, fo, lkl, lkh, lol, tps, trs, cnt, trank, tsl, tsh,
         lv) = g[e].unbind()
        rec.append(torch.stack([have, plk_lo, plk_hi, plord, c_cnt, c_rank,
                                c_slo, c_shi, c_lv]))
        ne = nv > 0
        cont = (have > 0) & ne & (fkl == plk_lo) & (fkh == plk_hi)
        cont_o = cont & (fo == plord)
        whole = cont & (tps > 0)
        n_cnt = (cnt + torch.where(whole, c_cnt, 0)) & U32_MASK
        n_rank = torch.where(
            trs == 0, trank + torch.where(whole, c_cnt, 0),
            torch.where(cont_o, c_rank,
                        trank + torch.where(cont, c_cnt, 0))) & U32_MASK
        alo = tsl + c_slo
        ahi = (tsh + c_shi + (alo >> 32)) & U32_MASK
        n_slo = torch.where(whole, alo & U32_MASK, tsl)
        n_shi = torch.where(whole, ahi, tsh)
        c_cnt, c_rank, c_slo, c_shi, c_lv, plk_lo, plk_hi, plord = (
            torch.where(ne, new, old) for new, old in (
                (n_cnt, c_cnt), (n_rank, c_rank), (n_slo, c_slo),
                (n_shi, c_shi), (lv, c_lv), (lkl, plk_lo), (lkh, plk_hi),
                (lol, plord)))
        have = torch.where(ne, 1, have)
    return torch.stack(rec)


def window_big_distributed(n: int, mesh, partitions: int | None = None,
                           run_size: int = 1 << 26,
                           buckets_per_dev: int | None = None, seed: int = 7,
                           samples_per_run: int = 4096,
                           verbose: bool = False, collect: bool = False,
                           force_composed: bool = False,
                           stats: dict | None = None):
    """Distributed out-of-core window over `mesh` (module docstring), on
    the mesh's device.

    n must be a multiple of D * run_size and < 2^31. The verified set is
    window_big's: row_number, rank, exact u64 running sum, lag. At D == 1
    the call delegates to window_big unless force_composed. Returns
    BigWindowResult; with collect=True also the rows and window columns on
    the host in global order. stats (a dict) receives "shard_rows", the
    rows each shard holds after the exchange (composed path only).
    """
    n_dev = mesh.n_dev
    dev = mesh.device
    if partitions is None:
        partitions = max(n // 1024, 1)
    if n_dev == 1 and not force_composed:
        return window_big(n, partitions=partitions, run_size=run_size,
                          n_buckets=buckets_per_dev, seed=seed,
                          samples_per_run=samples_per_run,
                          verbose=verbose, collect=collect, device=dev)
    assert n % (n_dev * run_size) == 0, \
        (f"n must be a multiple of devices*run_size "
         f"(n={n}, devices={n_dev}, run_size={run_size})")
    assert n < (1 << 31), "pad flag rides bit 31 of the index plane"
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
    with span("dbigwindow phase A: sorted runs"):
        runs = _runs(mesh, n_local, n_runs, run_size, partitions, seed)
    t_a = _fence(dev) - t0

    t0 = _fence(dev)
    with span("dbigwindow phase B: plan"):
        bounds = _plan(mesh, runs, S, per_run)
    t_b = _fence(dev) - t0
    pos, blk_start, blk_size, seg_size, cap_blk, cap_off = segment_plan(
        bounds, run_size, n_b)
    if verbose:
        print(f"dbigwindow: D={n_dev} R={n_runs} B={n_b} run={run_size} "
              f"cap_blk={cap_blk} cap_off={cap_off} "
              f"largest segment {int(seg_size.max())}")

    t0 = _fence(dev)
    with span("dbigwindow phase X: segment exchange"):
        blocks = exchange_runs(mesh, runs, blk_start, blk_size, cap_blk,
                               cap_off, _FILLS)
    del runs
    t_x = _fence(dev) - t0

    t0 = _fence(dev)
    with span("dbigwindow phase P: shard carries"):
        # sizes[i, r, s]: rows local shard i received from shard s's run r
        sizes = torch.from_numpy(np.ascontiguousarray(
            blk_size[:, :, ranks].transpose(2, 1, 0))).to(dev)
        summ = _summaries(blocks, sizes)
        # every shard gathers the same summaries: chain them once
        chain = _carry_chain(mesh.all_gather(summ)[0].reshape(n_dev, -1))
        carries = [chain[t] for t in ranks]
        del summ, chain
    t_p = _fence(dev) - t0

    t0 = _fence(dev)
    pending, collected = [], {}
    with span("dbigwindow phase C: bucket rounds"):
        for b in range(n_b):
            outs = []
            for i, t in enumerate(ranks):
                g = t * n_b + b
                cols, count = bucket_cols(blocks, i,
                                          pos[:, :, g] - blk_start[:, :, t],
                                          seg_size[:, :, g], _FILLS)
                lo, hi, o, idx, v = cols
                shi, slo, so, sidx, sv = sort_planes([hi, lo, o, idx, v], 3)
                del cols, lo, hi, o, idx, v
                checks, carries[i], planes = window_core(
                    shi, slo, so, sidx, sv, count, carries[i], partitions,
                    seed)
                outs.append(checks)
                if collect:
                    collected[(b, i)] = [x[:count] for x in (
                        slo, shi, so, sidx, sv, *(narrow(p) for p in planes))]
                del shi, slo, so, sidx, sv, planes
            pending.append(torch.stack(outs))
        scal = mesh.collect(torch.stack(pending, 1)).cpu().numpy()
    t_c = _fence(dev) - t0                        # scal: (D, B, N_CHECK)

    s_ok, h_ok, w_ok, cnt = (scal[..., j] for j in range(4))
    boundary_ok = True
    prev_last = None
    for t in range(n_dev):          # global bucket order g = t * B + b
        for b in range(n_b):
            if cnt[t, b] == 0:
                continue
            flo, fhi, fo, llo, lhi, lo_ = (int(x) for x in scal[t, b, 4:])
            if prev_last is not None:
                boundary_ok &= prev_last <= (fhi, flo, fo)
            prev_last = (lhi, llo, lo_)

    dt = t_a + t_b + t_x + t_p + t_c
    res = BigWindowResult(
        n=n, partitions=partitions, seconds=dt, rows_per_s=n / dt,
        sorted_ok=bool(s_ok.all()), hash_ok=bool(h_ok.all()),
        window_ok=bool(w_ok.all()), count_ok=int(cnt.sum()) == n,
        boundary_ok=boundary_ok, phase_a_s=t_a, phase_c_s=t_c,
        compile_s=compile_s)
    if stats is not None:
        stats["shard_rows"] = [int(x) for x in cnt.sum(1)]
    if verbose:
        print(f"dbigwindow phases: A={t_a:.2f}s B={t_b:.2f}s X={t_x:.2f}s "
              f"P={t_p:.2f}s C={t_c:.2f}s total={dt:.2f}s")
    if collect:
        full = {}
        for b in range(n_b):
            width = max(int(cnt[:, b].max()), 1)
            for j in range(10):
                mine = [torch.cat([collected[(b, i)][j], torch.zeros(
                    width - int(cnt[r, b]), dtype=torch.int32, device=dev)])
                    for i, r in enumerate(ranks)]
                full[(b, j)] = mesh.collect(torch.stack(mine)).cpu(
                ).numpy().view(np.uint32)
        slo, shi, so, sidx, sv, rn, rk, clo, chi, lg = (np.concatenate(
            [full[(b, j)][t, :int(cnt[t, b])] for t in range(n_dev)
             for b in range(n_b)]) for j in range(10))
        keys = slo.astype(np.uint64) | (shi.astype(np.uint64)
                                        << np.uint64(32))
        cum = clo.astype(np.uint64) | (chi.astype(np.uint64)
                                       << np.uint64(32))
        return res, dict(key=keys, order=so, idx=sidx, value=sv,
                         rn=rn, rk=rk, cum=cum, lg=lg)
    return res
