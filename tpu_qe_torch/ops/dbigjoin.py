"""Distributed out-of-core FK join over a mesh of shards, both sides larger
than any shard holds: the port of tpu_qe/ops/dbigjoin.py.

  phase A   per shard, per side: sorted runs of the shard's share of the
            side (left rows carry their global index as payload; right
            rows need none, the joined value is a closed form of the key:
            ops/bigjoin.py's data model), all local shards' indices made
            in one launch sequence;
  phase B   one splitter plan over the union of both key distributions
            (strided samples of every run of both sides, all_gathered,
            sorted once), each run's exact boundaries by
            ``searchsorted_u64``: every copy of a key lands in one bucket
            on both sides, so the bucket joins compose exactly. The plan
            crosses to the host once;
  phase X   per run and side, the segment exchange of sort/dbigsort.py
            (exchange_segments: only the off-diagonal slices enter the
            all_to_all): shard t receives buckets [t * B, (t + 1) * B) of
            every run of both sides;
  phase C   per shard, per local bucket: the bucket's segments of every
            (source, run) block of both sides, sliced exactly, and
            ``join_fk_scan`` with bigjoin's construction-exact checks (every
            left row's match flag and joined value, exact counts).

Only plan integers and check scalars cross to the host; phase C queues
every bucket before it reads any check back. Every sort is
``sort_planes`` (B1-B3 on the card) and stable. The reference's unstable
run sorts by (hi, lo[, idx]) give the same rows: a run is made in index
order, and rows of one key are the same row on the right (no payload).
Its sample sort ties only on equal keys. join_fk_scan sorts each bucket
itself, and no check depends on the order of its segments (right rows of
one key carry one value, a function of the key).

aggregate_groups fuses a partial GROUP BY of the joined values into every
bucket (ops/bigpipe.py's _bucket_partial, matched rows only) and returns
one (S, partial_cap) 5-plane table per bucket round, padded as bigagg
pads: ops/dbigpipe.py's composition. checkpoint_dir keeps the plan and
every bucket round's per-shard scalars (`dbigjoin_state.npz`, the
reference's file and meta), so a run stopped by either package resumes in
the other; on a GroupMesh rank 0 writes.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from tpu_qe_torch.bits import U64, narrow
from tpu_qe_torch.exchange.mesh import GroupMesh
from tpu_qe_torch.exchange.shuffle import ONES
from tpu_qe_torch.ops.bigagg import _ONES
from tpu_qe_torch.ops.bigjoin import (_join_bucket, _JoinState,
                                      _lkey_of_index, _rkey_of_index)
from tpu_qe_torch.ops.join import searchsorted_u64
from tpu_qe_torch.sort.bigsort import _build_seconds, _fence
from tpu_qe_torch.sort.dbigsort import (bucket_cols, exchange_runs,
                                        quantize, run_index, segment_plan,
                                        sort_shards)
from tpu_qe_torch.sort.planes import sort_planes
from tpu_qe_torch.utils.profiling import span

_PART_FILLS = (_ONES, _ONES, 0, 0, 0)   # a bigagg partial table's pads


def _side_runs(mesh, n_local, n_runs, run_size, n_r, seed, side):
    """Phase A for one side: per run, (S, run_size) planes sorted by key:
    (lo, hi) on the right, (lo, hi, idx) on the left."""
    runs = []
    for r in range(n_runs):
        idx = narrow(run_index(mesh, n_local, r, run_size, mesh.device))
        if side == "right":
            key = _rkey_of_index(idx, seed)
            del idx
            shi, slo = sort_shards([key.hi, key.lo], 2)
            runs.append([slo, shi])
        else:
            key = _lkey_of_index(idx, n_r, seed)
            shi, slo, sidx = sort_shards([key.hi, key.lo, idx], 2)
            runs.append([slo, shi, sidx])
        del key
    return runs


def _plan(mesh, runs, n_buckets_total: int, per_run: int) -> np.ndarray:
    """Phase B: union splitters at the (D * B)-quantiles of strided samples
    of every run of both sides (left runs, then right), and each run's
    exact boundaries: the whole mesh's (D, Rl + Rr, D * B - 1) int64 plan
    on the host."""
    run_size = runs[0][0].shape[1]
    dev = runs[0][0].device
    stride = max(run_size // per_run, 1)
    sel = torch.arange(per_run, device=dev) * stride % run_size
    s_lo = torch.cat([run[0][:, sel] for run in runs], 1)
    s_hi = torch.cat([run[1][:, sel] for run in runs], 1)
    # every shard gathers the same samples: sort them once
    g_hi, g_lo = sort_planes([mesh.all_gather(s_hi)[0],
                              mesh.all_gather(s_lo)[0]], 2)
    total = g_lo.shape[0]
    q = torch.arange(1, n_buckets_total, device=dev) * total \
        // n_buckets_total
    sp = U64(g_lo[q], g_hi[q])
    bounds = torch.stack([torch.stack([
        searchsorted_u64(U64(run[0][i], run[1][i]), sp, side="left")
        for run in runs]) for i in range(runs[0][0].shape[0])])
    return mesh.collect(bounds.to(torch.int64)).cpu().numpy()


@dataclasses.dataclass(frozen=True)
class DBigJoinResult:
    n_l: int
    n_r: int
    n_dev: int
    seconds: float
    rows_per_s: float
    matched: int
    match_ok: bool
    val_ok: bool
    count_ok: bool
    phase_a_s: float
    phase_b_s: float
    phase_x_s: float
    phase_c_s: float
    compile_s: float = 0.0

    @property
    def all_ok(self) -> bool:
        return self.match_ok and self.val_ok and self.count_ok


class _DJoinState(_JoinState):
    N_SCALARS = 6  # per device: match_ok, val_ok, n_matched, n_even, l, r

    @staticmethod
    def _path(directory: str) -> str:
        return os.path.join(directory, "dbigjoin_state.npz")


def _bucket_table(stream, n_groups: int, partial_cap: int):
    """One shard's joined bucket -> its padded partial GROUP BY table, five
    (partial_cap,) planes."""
    from tpu_qe_torch.ops.bigpipe import _bucket_partial
    s_llo, s_lhi, _, s_val, s_m, s_v = stream
    rows = s_llo.shape[0]
    dev = s_llo.device
    if rows == 0:
        return [torch.full((partial_cap,), f, dtype=torch.int32, device=dev)
                for f in _PART_FILLS]
    part = _bucket_partial(s_llo, s_lhi, s_val, s_m, s_v, n_groups,
                           min(n_groups, rows))
    return [torch.cat([p, p.new_full((partial_cap - p.shape[0],), f)])
            for p, f in zip(part, _PART_FILLS)]


def join_big_distributed(n_l: int, n_r: int, mesh,
                         run_size: int = 1 << 26,
                         buckets_per_dev: int | None = None, seed: int = 7,
                         samples_per_run: int = 4096,
                         verbose: bool = False,
                         checkpoint_dir: str | None = None,
                         force_composed: bool = False,
                         aggregate_groups: int | None = None,
                         stats: dict | None = None):
    """Distributed out-of-core FK join of n_l x n_r generated rows (module
    docstring), on the mesh's device.

    Both sides must be multiples of D * run_size. Every left row's match
    flag and joined value are checked on the device against the
    generator's closed form (matches are exactly the even left indices).
    At D == 1 the call delegates to join_big (its BigJoinResult) unless
    force_composed. aggregate_groups: returns (DBigJoinResult, tables),
    one (S, partial_cap) 5-plane partial table per bucket round for
    dbigagg's combine; not with checkpoint_dir. stats (a dict) receives
    "shard_rows", the left and right rows each shard joined (composed
    path only).
    """
    n_dev = mesh.n_dev
    dev = mesh.device
    if n_dev == 1 and not force_composed:
        from tpu_qe_torch.ops.bigjoin import join_big
        return join_big(n_l, n_r, n_buckets=buckets_per_dev, seed=seed,
                        verbose=verbose, checkpoint_dir=checkpoint_dir,
                        device=dev)
    assert n_l % (n_dev * run_size) == 0, (n_l, n_dev, run_size)
    assert n_r % (n_dev * run_size) == 0, (n_r, n_dev, run_size)
    assert n_l < (1 << 32) and n_r < (1 << 32)
    # skipped rounds would have no tables: the fused caller keeps its own
    assert aggregate_groups is None or checkpoint_dir is None, \
        "aggregate_groups is incompatible with checkpoint_dir"
    nl_local, nr_local = n_l // n_dev, n_r // n_dev
    n_runs_l, n_runs_r = nl_local // run_size, nr_local // run_size
    if buckets_per_dev is None:
        buckets_per_dev = max(1, int(np.ceil(
            (nl_local + nr_local) / (1 << 26))))
    n_b = buckets_per_dev
    S = n_dev * n_b
    per_run = min(samples_per_run, run_size)
    quantum = 1 << 20 if run_size >= (1 << 22) else 256
    writer = not isinstance(mesh, GroupMesh) or mesh.rank == 0
    ranks = mesh.ranks().tolist()
    compile_s = _build_seconds(dev)

    t0 = _fence(dev)
    with span("dbigjoin phase A: side runs"):
        lruns = _side_runs(mesh, nl_local, n_runs_l, run_size, n_r, seed,
                           "left")
        rruns = _side_runs(mesh, nr_local, n_runs_r, run_size, n_r, seed,
                           "right")
    t_a = _fence(dev) - t0

    # a resumed run reuses the persisted plan
    meta = np.asarray([n_l, n_r, n_dev, run_size, n_b, seed, per_run],
                      np.int64)
    state = (_DJoinState.load(checkpoint_dir, meta)
             if checkpoint_dir is not None else None)
    t_b = 0.0
    if state is not None:
        bounds = state.bounds.reshape(n_dev, n_runs_l + n_runs_r, S - 1)
    else:
        t0 = _fence(dev)
        with span("dbigjoin phase B: plan"):
            bounds = _plan(mesh, lruns + rruns, S, per_run)
        t_b = _fence(dev) - t0
        if checkpoint_dir is not None and writer:
            state = _DJoinState.fresh(
                checkpoint_dir, meta, bounds, n_b,
                n_scalars=n_dev * _DJoinState.N_SCALARS)

    sides = []
    for part in (bounds[:, :n_runs_l], bounds[:, n_runs_l:]):
        pos, bs, bz, seg, cb, co = segment_plan(part, run_size, n_b)
        sides.append((pos, bs, bz, seg, cb, co,
                      quantize(int(seg.max()), quantum, cb)))
    cs_l, cs_r = sides[0][6], sides[1][6]
    # one bucket's combined padded stream (the reference's static layout)
    # must fit the in-core join
    assert (n_runs_l * n_dev * cs_l + n_runs_r * n_dev * cs_r) < (1 << 30), \
        ("bucket join exceeds join_fk_scan's combined cap; raise "
         "buckets_per_dev", cs_l, cs_r)
    if verbose:
        print(f"dbigjoin: D={n_dev} Rl={n_runs_l} Rr={n_runs_r} B={n_b} "
              f"cap_blk_l={sides[0][4]} cap_seg_l={cs_l} "
              f"cap_blk_r={sides[1][4]} cap_seg_r={cs_r}")

    t0 = _fence(dev)
    with span("dbigjoin phase X: segment exchange"):
        lblocks = exchange_runs(mesh, lruns, *sides[0][1:3], *sides[0][4:6],
                                (ONES, ONES, 0))
        rblocks = exchange_runs(mesh, rruns, *sides[1][1:3], *sides[1][4:6],
                                (ONES, ONES))
    del lruns, rruns
    t_x = _fence(dev) - t0

    pc = None
    if aggregate_groups is not None:
        # a bucket holds no more distinct groups than its static left
        # capacity (the reference's table size)
        pc = min(aggregate_groups, n_runs_l * n_dev * cs_l)
        pc = -(-pc // 128) * 128

    t0 = _fence(dev)
    skip = set()
    if state is not None:
        skip = {b for b in range(n_b) if state.done[b]}
        if verbose and skip:
            print(f"dbigjoin: resuming — {len(skip)}/{n_b} bucket rounds "
                  "already joined")
    pending, tables = {}, []
    (pos_l, bs_l, _, seg_l), (pos_r, bs_r, _, seg_r) = (s[:4] for s in sides)
    with span("dbigjoin phase C: bucket joins"):
        for b in range(n_b):
            if b in skip:
                continue
            outs, parts = [], []
            for i, t in enumerate(ranks):
                g = t * n_b + b
                (llo, lhi, lidx), nl_b = bucket_cols(
                    lblocks, i, pos_l[:, :, g] - bs_l[:, :, t],
                    seg_l[:, :, g], (ONES, ONES, 0))
                (rlo, rhi), nr_b = bucket_cols(
                    rblocks, i, pos_r[:, :, g] - bs_r[:, :, t],
                    seg_r[:, :, g], (ONES, ONES))
                scal, stream = _join_bucket(0, nl_b, 0, nr_b, llo, lhi, lidx,
                                            rlo, rhi)
                outs.append(scal)
                if pc is not None:
                    parts.append(_bucket_table(stream, aggregate_groups, pc))
                del stream, llo, lhi, lidx, rlo, rhi
            pending[b] = torch.stack(outs)                  # (S, 6)
            if pc is not None:
                tables.append(tuple(torch.stack(c) for c in zip(*parts)))
    matched = expected = rows_l = rows_r = 0
    m_ok = v_ok = True
    shard_rows = np.zeros(n_dev, np.int64)
    for b in range(n_b):
        if b in skip:
            vals = state.scalars[b].reshape(n_dev, _DJoinState.N_SCALARS)
        else:
            vals = mesh.collect(pending.pop(b)).cpu().numpy()   # (D, 6)
            if state is not None and writer:
                state.record(b, vals.reshape(-1))
        mo, vo, nm, ne, nl_b, nr_b = vals.T
        m_ok &= bool(mo.all())
        v_ok &= bool(vo.all())
        matched += int(nm.sum())
        expected += int(ne.sum())
        rows_l += int(nl_b.sum())
        rows_r += int(nr_b.sum())
        shard_rows += nl_b + nr_b
    if checkpoint_dir is not None:
        mesh.barrier()          # rank 0's last record is on the disk
    t_c = _fence(dev) - t0

    count_ok = (rows_l == n_l and rows_r == n_r
                and matched == expected == (n_l + 1) // 2)
    dt = t_a + t_b + t_x + t_c
    res = DBigJoinResult(
        n_l=n_l, n_r=n_r, n_dev=n_dev, seconds=dt, rows_per_s=n_l / dt,
        matched=matched, match_ok=m_ok, val_ok=v_ok, count_ok=count_ok,
        phase_a_s=t_a, phase_b_s=t_b, phase_x_s=t_x, phase_c_s=t_c,
        compile_s=compile_s)
    if stats is not None:
        stats["shard_rows"] = [int(x) for x in shard_rows]
    if verbose:
        print(f"dbigjoin: matched={matched}/{expected} rows_l={rows_l} "
              f"rows_r={rows_r} A={t_a:.2f} X={t_x:.2f} C={t_c:.2f} "
              f"ok={res.all_ok}")
    if aggregate_groups is not None:
        return res, tables
    return res
