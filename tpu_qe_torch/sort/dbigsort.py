"""Distributed out-of-core sort: data larger than one shard's sortable set,
sorted over a mesh of shards. The port of tpu_qe/sort/dbigsort.py.

It composes the out-of-core sort (sort/bigsort.py: sorted runs, a
splitter plan, bucket merges) with the mesh (exchange/mesh.py):

  phase A  every shard forms R sorted runs of its local rows, generated
           from the regenerable index hash (key = hash(global index),
           payload = the index, value columns hashes of it);
  phase B  one global plan: strided samples of every sorted run are
           all-gathered and sorted, splitters at the (D * B)-quantiles,
           and each run's exact boundaries (a search of the splitters);
           the plan's integers cross to the host, which sizes the
           capacities from the exact demand;
  phase X  per run, a segment all_to_all: the rows a run sends to shard t
           are one contiguous slice of the sorted run, so each (run, dest)
           segment is gathered into a block; only the off-diagonal blocks
           enter the all_to_all, at `cap_off`, and each shard's own
           (diagonal) share is placed locally at `cap_blk`
           (exchange_segments);
  phase C  every shard merges its B buckets: each bucket's sub-segments
           of every (source, run) block, concatenated, one sort, and the
           certificates on the device (sortedness, key == hash(payload)
           and every value column == its hash, count, payload sum and sum
           of squares mod 2^32, first and last key); only scalars cross to
           the host, which checks the order across buckets.

Where the JAX package slides fixed windows over its runs and blocks
(a start clamped downward, the difference masked), the port gathers and
slices each segment at its exact bounds, as its sort_big does: the same
blocks, rows and certificates. Its merge concatenates a bucket's segments
in (source, run) order, which is global index order for equal keys, so
one stable sort by key gives the JAX package's sort by (key, index); and
it sorts the bucket's real rows only, without the sentinel tail.

Every sort is ``sort.planes.sort_planes`` (B1-B3 on the card). At D = 1
the exchange has nothing to move and the call delegates to sort_big
unless force_composed is set. On a LocalMesh of D > 1 shards one card
does every shard's work, its all_to_all a copy in the card's memory.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_qe_torch.bits import U64
from tpu_qe_torch.config import resolve_device
from tpu_qe_torch.exchange.mesh import GroupMesh
from tpu_qe_torch.exchange.shuffle import ONES, i32
from tpu_qe_torch.hashing import keygen_hash, keygen_hash_numpy
from tpu_qe_torch.ops.join import searchsorted_u64
from tpu_qe_torch.sort.bigsort import (BigSortResult, _build_seconds,
                                       _certify, _fence, _rows, _want_sums)
from tpu_qe_torch.sort.planes import sort_planes
from tpu_qe_torch.utils.checkpoint import RunState
from tpu_qe_torch.utils.profiling import span

N_SCALARS = RunState.N_SCALARS


def keygen_masked(idx: torch.Tensor, seed: int, key_bits: int) -> U64:
    """keygen_hash with the keys narrowed to key_bits bits: 2^key_bits
    distinct values, the adversarial-duplicates regime of a splitter
    sort. An output row still verifies as key == keygen_masked(payload)."""
    k = keygen_hash(idx, seed)
    if key_bits >= 64:
        return k
    if key_bits <= 32:
        return U64(k.lo & i32((1 << key_bits) - 1), torch.zeros_like(k.hi))
    return U64(k.lo, k.hi & i32((1 << (key_bits - 32)) - 1))


def keygen_masked_numpy(idx: np.ndarray, seed: int = 7,
                        key_bits: int = 64) -> np.ndarray:
    """numpy mirror of keygen_masked (oracle checks)."""
    k = keygen_hash_numpy(idx, seed)
    if key_bits >= 64:
        return k
    return k & np.uint64((1 << key_bits) - 1)


def quantize(demand: int, quantum: int, ceiling: int) -> int:
    """A static capacity for `demand` rows: rounded up to the quantum, at
    most `ceiling`."""
    return min(-(-max(demand, 1) // quantum) * quantum, ceiling)


def exchange_segments(mesh, starts: torch.Tensor, sizes: torch.Tensor,
                      cols, cap_blk: int, cap_off: int, fills=None):
    """Segment exchange of one run: shard s sends rows [starts[s, t],
    starts[s, t] + sizes[s, t]) of its run to shard t.

    starts, sizes: (S, D) int64 on the mesh's device, this process's rows
    of the plan; cols: (S, run) int32 planes, with fills (default: the
    sort's all-ones key words, payloads 0). Two-tier: only the
    off-diagonal segments (sizes at most cap_off) enter the all_to_all;
    each shard's own segment (at most cap_blk) is placed locally. Returns
    (S, D, cap_blk) blocks per column: row j holds the segment received
    from shard j, then the fill.
    """
    if fills is None:
        fills = (ONES, ONES) + (0,) * (len(cols) - 2)
    shards, run = cols[0].shape
    n_dev = mesh.n_dev
    dev = cols[0].device
    me = mesh.ranks()
    rows = torch.arange(shards, device=dev)
    base = rows[:, None] * run
    j = torch.arange(cap_off, device=dev)
    diag = torch.arange(n_dev, device=dev)[None] == me[:, None]
    in_off = (j < sizes[:, :, None]) & ~diag[:, :, None]     # (S, D, cap)
    off_idx = (torch.clamp(starts[:, :, None] + j, max=run - 1)
               + base[:, :, None]).reshape(-1)
    jd = torch.arange(cap_blk, device=dev)
    d_in = jd < sizes.gather(1, me[:, None])                # (S, cap_blk)
    d_idx = (torch.clamp(starts.gather(1, me[:, None]) + jd, max=run - 1)
             + base).reshape(-1)
    out = []
    for c, f in zip(cols, fills):
        flat = c.reshape(-1)
        blk = torch.full((shards, n_dev, cap_blk), i32(f), dtype=torch.int32,
                         device=dev)
        if n_dev > 1:
            x = torch.where(in_off, flat[off_idx].reshape(
                shards, n_dev, cap_off), i32(f))
            blk[:, :, :cap_off] = mesh.all_to_all(x)
            del x
        blk[rows, me] = torch.where(d_in, flat[d_idx].reshape(
            shards, cap_blk), i32(f))
        out.append(blk)
    return out


def _form_runs(mesh, n_local, n_runs, run_size, seed, key_bits,
               payload_cols, dev):
    """Phase A: per run, (S, run_size) planes (key lo, key hi, index,
    value columns), every local shard's run sorted by key (stable: ties
    in index order)."""
    ranks = mesh.ranks().tolist()
    runs = []
    for r in range(n_runs):
        run = [torch.empty(len(ranks), run_size, dtype=torch.int32,
                           device=dev) for _ in range(2 + payload_cols)]
        for i, d in enumerate(ranks):
            lo, hi, *rest = _rows(d * n_local + r * run_size, run_size, seed,
                                  payload_cols, dev)
            if key_bits < 64:
                lo, hi = keygen_masked(rest[0], seed, key_bits)
            shi, slo, *srest = sort_planes([hi, lo, *rest], 2)
            for c, p in zip(run, [slo, shi, *srest]):
                c[i] = p
        runs.append(run)
    return runs


def _plan(mesh, runs, n_buckets_total: int, per_run: int) -> np.ndarray:
    """Phase B: global splitters at the (D * B)-quantiles of strided
    samples of every sorted run, and each run's exact boundaries: the
    whole mesh's (D, R, D * B - 1) int64 plan on the host."""
    run_size = runs[0][0].shape[1]
    dev = runs[0][0].device
    stride = max(run_size // per_run, 1)
    sel = torch.arange(per_run, device=dev) * stride % run_size
    s_lo = torch.cat([run[0][:, sel] for run in runs], 1)
    s_hi = torch.cat([run[1][:, sel] for run in runs], 1)
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


def run_index(mesh, n_local: int, r: int, run_size: int,
              device) -> torch.Tensor:
    """(S, run_size) int64 global row indices of every local shard's run
    r: shard d's run r holds rows d * n_local + r * run_size + [0,
    run_size)."""
    return (mesh.ranks()[:, None] * n_local + r * run_size
            + torch.arange(run_size, device=device))


def sort_shards(planes, num_keys: int):
    """Every local shard's rows of the (S, n) int32 planes sorted by the
    first num_keys planes (sort_planes: stable, B1-B3 on the card), into
    fresh (S, n) planes."""
    out = [torch.empty_like(p) for p in planes]
    for i in range(planes[0].shape[0]):
        for o, p in zip(out, sort_planes([p[i] for p in planes], num_keys)):
            o[i] = p
    return out


def segment_plan(bounds: np.ndarray, run_size: int, n_b: int):
    """The host plan of the whole mesh's (D, R, D * B - 1) run boundaries:
    pos (D, R, S + 1), where bucket g of (shard d, run r) is rows
    [pos[d, r, g], pos[d, r, g + 1]); blk_start and blk_size (D, R, D), the
    slice of each run bound for each shard; seg_size (D, R, S); and the
    exchange's capacities cap_blk (a shard's own slice) and cap_off (the
    others'), sized from the exact demand."""
    n_dev, n_runs = bounds.shape[:2]
    S = n_dev * n_b
    quantum = 1 << 20 if run_size >= (1 << 22) else 256
    pos = np.concatenate([np.zeros((n_dev, n_runs, 1), np.int64),
                          bounds.astype(np.int64),
                          np.full((n_dev, n_runs, 1), run_size, np.int64)],
                         axis=2)
    blk_start = pos[:, :, 0:S + 1:n_b][:, :, :-1]         # (D, R, D)
    blk_size = pos[:, :, n_b:S + 1:n_b] - blk_start
    cap_blk = quantize(int(blk_size.max()), quantum, run_size)
    eye = np.eye(n_dev, dtype=bool)[:, None, :]
    off_max = int(np.where(eye, 0, blk_size).max()) if n_dev > 1 else 0
    cap_off = quantize(off_max, quantum, cap_blk) if n_dev > 1 else 16
    seg_size = pos[:, :, 1:] - pos[:, :, :-1]             # (D, R, S)
    return pos, blk_start, blk_size, seg_size, cap_blk, cap_off


def exchange_runs(mesh, runs, blk_start, blk_size, cap_blk: int,
                  cap_off: int, fills):
    """Phase X: every run's segment exchange (exchange_segments), each run
    dropped (runs[r] = None) once its exchange is queued. Returns the
    blocks, one list of (S, D, cap_blk) planes per run."""
    ranks = mesh.ranks().tolist()
    dev = mesh.device
    blocks = []
    for r in range(len(runs)):
        def plan_rows(x):
            return torch.from_numpy(np.ascontiguousarray(
                x[ranks, r, :])).to(dev)
        blocks.append(exchange_segments(
            mesh, plan_rows(blk_start), plan_rows(blk_size), runs[r],
            cap_blk, cap_off, fills))
        runs[r] = None
    return blocks


def bucket_cols(blocks, i: int, offs, sizes, fills):
    """Local shard i's segments of one bucket: from every (source, run)
    block, in (source, run) order, which is global index order for rows
    of equal keys; concatenated per column. offs / sizes: (D, R)
    within-block offsets and sizes. Returns (cols, count); an empty bucket
    is one row of `fills` (the callers read row 0)."""
    n_dev, n_runs = sizes.shape
    count = int(sizes.sum())
    cols = []
    for c, f in enumerate(fills):
        parts = [blocks[r][c][i, s, int(offs[s, r]):int(offs[s, r])
                              + int(sizes[s, r])]
                 for s in range(n_dev) for r in range(n_runs)]
        if count == 0:
            parts.append(torch.full((1,), i32(f), dtype=torch.int32,
                                    device=blocks[0][c].device))
        cols.append(torch.cat(parts))
    return cols, count


def _merge(blocks, i: int, offs, sizes, seed, key_bits):
    """Phase C for local shard i and one bucket: its segments of every
    (source, run) block, sorted; returns (scalars, sorted planes, count).
    offs / sizes: (D, R) within-block offsets and sizes of the bucket's
    segments."""
    fills = (ONES, ONES) + (0,) * (len(blocks[0]) - 2)
    cols, count = bucket_cols(blocks, i, offs, sizes, fills)
    shi, slo, spay, *svals = sort_planes([cols[1], cols[0], *cols[2:]], 2)
    del cols
    scal = _certify(slo, shi, spay, svals, count, seed,
                    keygen=lambda p, s: keygen_masked(p, s, key_bits))
    return scal, (slo, shi, spay, *svals), count


def sort_big_distributed(n: int, mesh, run_size: int = 1 << 26,
                         buckets_per_dev: int | None = None, seed: int = 7,
                         samples_per_run: int = 4096, key_bits: int = 64,
                         verbose: bool = False, collect: bool = False,
                         checkpoint_dir: str | None = None,
                         force_composed: bool = False,
                         payload_cols: int = 1,
                         device: str | torch.device | None = None,
                         stats: dict | None = None):
    """Distributed out-of-core sort of n generated rows over `mesh`
    (module docstring), with full verification.

    n must be a multiple of D * run_size (D = mesh.n_dev). Shard d's
    output, bucket by bucket, is the d-th quantile range of the global
    order. key_bits < 64 narrows the keys (duplicates). device: the mesh's
    device (None), or the same device named.

    With D == 1 and 64-bit keys the call delegates to sort_big (same data
    model and checks) unless force_composed. Returns BigSortResult (its
    time covers phases A, B, X and C; the kernels' build is outside); with
    collect=True also (keys, payload[, value columns]) on the host in
    global order (small-n oracle checks). checkpoint_dir: the plan and
    every bucket round's scalars persist (utils/checkpoint.RunState; on a
    GroupMesh rank 0 writes them); a killed run resumes with phases A and
    X regenerated, the plan loaded and completed rounds replaying their
    scalars; collect=True re-merges with the persisted plan. stats (a
    dict) receives "shard_rows", the rows each shard holds after the sort
    (composed path only).
    """
    dev = mesh.device
    if device is not None and resolve_device(device) != dev:
        raise ValueError(f"device {device} is not the mesh's ({dev})")
    n_dev = mesh.n_dev
    if n_dev == 1 and key_bits == 64 and not force_composed:
        from tpu_qe_torch.sort.bigsort import sort_big
        return sort_big(n, run_size=run_size, n_buckets=buckets_per_dev,
                        seed=seed, samples_per_run=samples_per_run,
                        verbose=verbose, collect=collect,
                        checkpoint_dir=checkpoint_dir,
                        payload_cols=payload_cols, device=dev)
    assert n % (n_dev * run_size) == 0, \
        (f"n must be a multiple of devices*run_size "
         f"(n={n}, devices={n_dev}, run_size={run_size})")
    assert n < (1 << 32), "payload travels as u32 global index"
    assert payload_cols >= 1, payload_cols
    n_local = n // n_dev
    n_runs = n_local // run_size
    if buckets_per_dev is None:
        buckets_per_dev = max(1, int(np.ceil(n_local / (1 << 26))))
    n_b = buckets_per_dev
    S = n_dev * n_b
    per_run = min(samples_per_run, run_size)
    meta = np.asarray([n, n_dev, run_size, n_b, seed, per_run, key_bits,
                       payload_cols], dtype=np.int64)
    state = (RunState.load(checkpoint_dir, meta)
             if checkpoint_dir is not None else None)
    writer = not isinstance(mesh, GroupMesh) or mesh.rank == 0
    compile_s = _build_seconds(dev)

    t0 = _fence(dev)
    with span("dbigsort phase A: runs"):
        runs = _form_runs(mesh, n_local, n_runs, run_size, seed, key_bits,
                          payload_cols, dev)
    t_a = _fence(dev) - t0

    # a resumed run reuses the persisted plan (completed buckets mean
    # nothing against other boundaries)
    t_b = 0.0
    if state is not None:
        bounds = state.bounds.reshape(n_dev, n_runs, S - 1)
    else:
        t0 = _fence(dev)
        with span("dbigsort phase B: plan"):
            bounds = _plan(mesh, runs, S, per_run)
        t_b = _fence(dev) - t0
        if checkpoint_dir is not None and writer:
            state = RunState.fresh(checkpoint_dir, meta, bounds, n_b,
                                   n_scalars=n_dev * N_SCALARS)
    pos, blk_start, blk_size, seg_size, cap_blk, cap_off = segment_plan(
        bounds, run_size, n_b)
    if verbose:
        print(f"dbigsort: D={n_dev} R={n_runs} B={n_b} run={run_size} "
              f"cap_blk={cap_blk} (max {int(blk_size.max())}) "
              f"cap_off={cap_off}")

    t0 = _fence(dev)
    ranks = mesh.ranks().tolist()
    with span("dbigsort phase X: segment exchange"):
        blocks = exchange_runs(mesh, runs, blk_start, blk_size, cap_blk,
                               cap_off, (ONES, ONES) + (0,) * payload_cols)
    del runs
    t_x = _fence(dev) - t0

    t0 = _fence(dev)
    scal = np.zeros((n_b, n_dev, N_SCALARS), np.int64)
    skip = set()
    if state is not None and not collect:
        for b in range(n_b):
            if state.done[b]:
                scal[b] = state.scalars[b].reshape(n_dev, N_SCALARS)
                skip.add(b)
        if verbose and skip:
            print(f"dbigsort: resuming — {len(skip)}/{n_b} bucket rounds "
                  "already merged")
    collected = {}
    with span("dbigsort phase C: bucket merges"):
        for b in range(n_b):
            if b in skip:
                continue
            outs, arrays, counts = [], [], []
            for i, t in enumerate(ranks):
                g = t * n_b + b
                # within-block offsets of bucket g's segments, (src, run)
                offs = pos[:, :, g] - blk_start[:, :, t]
                out, arr, count = _merge(blocks, i, offs, seg_size[:, :, g],
                                         seed, key_bits)
                outs.append(out)
                arrays.append(arr)
                counts.append(count)
            vals = mesh.collect(torch.stack(outs)).cpu().numpy()  # (D, 9)
            scal[b] = vals
            if state is not None and writer:
                state.record(b, vals.reshape(-1))
            if collect:
                m = max(int(seg_size[:, :, t * n_b + b].sum())
                        for t in range(n_dev))
                for c in range(2 + payload_cols):
                    padded = torch.stack([torch.cat([a[c][:k], torch.zeros(
                        m - k, dtype=torch.int32, device=dev)])
                        for a, k in zip(arrays, counts)])
                    full = mesh.collect(padded).cpu().numpy().view(np.uint32)
                    for t in range(n_dev):
                        k = int(vals[t, 2])
                        collected.setdefault(t * n_b + b, []).append(
                            full[t, :k])
            del arrays
            if verbose:
                print(f"  bucket {b}: counts={vals[:, 2].tolist()} "
                      f"sorted={bool(vals[:, 0].all())} "
                      f"hash={bool(vals[:, 1].all())}")
    if checkpoint_dir is not None:
        mesh.barrier()          # rank 0's last record is on the disk
    t_c = _fence(dev) - t0

    total_count, sum_pay, sum_sq = 0, 0, 0
    all_sorted = all_hash = boundary_ok = True
    prev_last = None
    # global bucket order g = t * B + b
    for t in range(n_dev):
        for b in range(n_b):
            s_ok, h_ok, cnt, psum, psq, flo, fhi, llo, lhi = (
                int(v) for v in scal[b, t])
            all_sorted &= bool(s_ok)
            all_hash &= bool(h_ok)
            total_count += cnt
            sum_pay = (sum_pay + psum) & 0xFFFFFFFF
            sum_sq = (sum_sq + psq) & 0xFFFFFFFF
            if cnt == 0:
                continue
            if prev_last is not None:
                boundary_ok &= prev_last <= (fhi, flo)
            prev_last = (lhi, llo)

    dt = t_a + t_b + t_x + t_c
    res = BigSortResult(
        n=n, seconds=dt, keys_per_s=n / dt, sorted_ok=all_sorted,
        hash_ok=all_hash, count_ok=total_count == n,
        perm_ok=(sum_pay, sum_sq) == _want_sums(n), boundary_ok=boundary_ok,
        phase_a_s=t_a, phase_c_s=t_c, compile_s=compile_s)
    if stats is not None:
        stats["shard_rows"] = [int(v) for v in scal[:, :, 2].sum(0)]
    if verbose:
        print(f"dbigsort phases: A={t_a:.2f}s B={t_b:.2f}s X={t_x:.2f}s "
              f"C={t_c:.2f}s total={dt:.2f}s")
    if collect:
        cols = [np.concatenate([collected[g][c] for g in range(S)])
                for c in range(2 + payload_cols)]
        keys = cols[0].astype(np.uint64) | (cols[1].astype(np.uint64)
                                            << np.uint64(32))
        if payload_cols > 1:
            return res, (keys, cols[2], tuple(cols[3:]))
        return res, (keys, cols[2])
    return res

