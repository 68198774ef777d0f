"""Out-of-core single-device sort, the north-star configuration of
BASELINE.json (1B u64 keys + a u32 payload on one card): the port of
tpu_qe/sort/bigsort.py.

A device-resident external sample sort; no input array ever exists:

  phase A (runs)   generate each run of `run_size` rows on the device from
                   the regenerable index hash (key = keygen_hash(i),
                   payload = i, value column j = a hash of i) and either
                   sort it by key ("merge") or group it by destination
                   bucket with one sort of the bucket id ("partition");
                   the runs stay resident;
  phase B (plan)   splitters at the bucket quantiles of strided samples
                   (generated before any run for "partition", read from
                   the sorted runs for "merge") and each run's segment
                   boundaries; a few integers cross to the host, which
                   sizes a static segment capacity from the exact demand;
  phase C (merge)  per output bucket: the runs' segments concatenated, a
                   tail of sentinel rows to the capacity, one sort, then
                   certificates computed on the device and only scalars
                   read back: full sortedness, key == hash(payload) and
                   every value column == its hash of the payload, exact
                   counts, payload sum and sum of squares mod 2^32
                   (permutation evidence) and the bucket's first and last
                   keys (order across buckets).

Every sort is ``sort_planes`` (the B1-B3 radix kernels on the card). The
reference's sorts end in the unique row index (payload) as a third key, to
make an unstable sort deterministic; the port's sorts are stable and drop
it. That gives the same order because,
in every input the port sorts, rows of equal keys already stand in
ascending index order:
- a run is generated in index order, and its sorts are stable;
- the partition strategy's bucket-id sort is stable, so each bucket's
  segment of a run keeps index order;
- a bucket is the concatenation of its run segments in run order, and run
  r holds indices [r * run_size, (r + 1) * run_size);
- the sentinel tail comes after every real row, so sentinels stay behind
  real rows even where a real key is all ones.

Phases are fenced with torch.cuda.synchronize(). `compile_s` is the time
the CUDA kernels took to build at first use (0 when they were built, and
on the CPU).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from tpu_qe_torch.bits import U32_MASK, U64, narrow, widen
from tpu_qe_torch.config import resolve_device
from tpu_qe_torch.hashing import keygen_hash, murmur_fmix32, \
    murmur_fmix32_numpy
from tpu_qe_torch.ops.join import searchsorted_u64
from tpu_qe_torch.sort.planes import sort_planes
from tpu_qe_torch.utils.checkpoint import RunState
from tpu_qe_torch.utils.profiling import span

# rows generated or certified per step: bounds the int64 temporaries of the
# hash arithmetic (8 B a row each)
CHUNK = 1 << 24


def _value_salt(j: int, seed: int) -> int:
    return ((0xA5A5A5A5 + 0x1003F * j) ^ seed) & U32_MASK


def _value_col(idx: torch.Tensor, j: int, seed: int) -> torch.Tensor:
    """Value column j of rows `idx` (int32 planes): a hash of the index,
    regenerable for verification but carried through every sort like
    table data."""
    salt = int(narrow(torch.tensor(_value_salt(j, seed))))
    return murmur_fmix32(idx ^ salt)


def _value_col_numpy(idx: np.ndarray, j: int, seed: int = 7) -> np.ndarray:
    return murmur_fmix32_numpy(idx.astype(np.uint32)
                               ^ np.uint32(_value_salt(j, seed)))


def _rows(start: int, count: int, seed: int, payload_cols: int, device):
    """Rows start .. start + count - 1 as int32 planes (key lo, key hi,
    index, value columns), made CHUNK rows at a time."""
    planes = [torch.empty(count, dtype=torch.int32, device=device)
              for _ in range(2 + payload_cols)]
    for a in range(0, count, CHUNK):
        b = min(a + CHUNK, count)
        idx = narrow(torch.arange(start + a, start + b, device=device))
        key = keygen_hash(idx, seed)
        planes[0][a:b], planes[1][a:b], planes[2][a:b] = key.lo, key.hi, idx
        for j in range(payload_cols - 1):
            planes[3 + j][a:b] = _value_col(idx, j, seed)
    return planes


def _sq_mod32(x: torch.Tensor) -> torch.Tensor:
    """x * x mod 2^32 for int64 x in [0, 2^32), without leaving int64."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * lo + (((lo * hi) << 17) & U32_MASK)) & U32_MASK


def _certify(slo, shi, spay, svals, n_valid: int, seed: int,
             keygen=keygen_hash):
    """The nine certificate scalars of a sorted bucket (s_ok, h_ok, count,
    payload sum and sum of squares mod 2^32, first and last key words) as
    one int64 tensor on the device; rows past n_valid are sentinels.
    keygen(payload, seed) is the key each row must hold."""
    dev = slo.device
    ok_sorted = torch.ones((), dtype=torch.bool, device=dev)
    ok_hash = torch.ones((), dtype=torch.bool, device=dev)
    psum = torch.zeros((), dtype=torch.int64, device=dev)
    psq = torch.zeros((), dtype=torch.int64, device=dev)
    for a in range(0, n_valid, CHUNK):
        b = min(a + CHUNK, n_valid)
        lo, hi = widen(slo[max(a - 1, 0):b]), widen(shi[max(a - 1, 0):b])
        ok_sorted &= ((hi[1:] > hi[:-1])
                      | ((hi[1:] == hi[:-1]) & (lo[1:] >= lo[:-1]))).all()
        pay = spay[a:b]
        want = keygen(pay, seed)
        ok_hash &= ((slo[a:b] == want.lo) & (shi[a:b] == want.hi)).all()
        # every value column still belongs to its row's index
        for j, sv in enumerate(svals):
            ok_hash &= (sv[a:b] == _value_col(pay, j, seed)).all()
        w = widen(pay)
        psum += w.sum()
        psq += _sq_mod32(w).sum()
    last = max(n_valid, 1) - 1
    return torch.stack([
        ok_sorted.to(torch.int64), ok_hash.to(torch.int64),
        torch.tensor(n_valid, dtype=torch.int64, device=dev),
        psum & U32_MASK, psq & U32_MASK, widen(slo[0]), widen(shi[0]),
        widen(slo[last]), widen(shi[last])])


def _want_sums(n: int) -> tuple[int, int]:
    """Sum and sum of squares of 0 .. n-1, mod 2^32."""
    return ((n * (n - 1) // 2) & U32_MASK,
            ((n - 1) * n * (2 * n - 1) // 6) & U32_MASK)


@dataclasses.dataclass(frozen=True)
class BigSortResult:
    n: int
    seconds: float
    keys_per_s: float
    sorted_ok: bool
    hash_ok: bool
    count_ok: bool
    perm_ok: bool
    boundary_ok: bool
    phase_a_s: float
    phase_c_s: float
    compile_s: float = 0.0

    @property
    def all_ok(self) -> bool:
        return (self.sorted_ok and self.hash_ok and self.count_ok
                and self.perm_ok and self.boundary_ok)


def _fence(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _build_seconds(device) -> float:
    """Seconds the CUDA kernels take to build now: their build at first
    use (0 when built, and for a CPU device)."""
    if device.type != "cuda":
        return 0.0
    from tpu_qe_torch import kernels
    t0 = time.perf_counter()
    kernels.library()
    return time.perf_counter() - t0


def sort_big_incore(n: int, seed: int = 7,
                    device: str | torch.device = "cuda") -> BigSortResult:
    """One resident sort of n generated rows and its full verification:
    generate, sort by key, certify; scalars out."""
    dev = resolve_device(device)
    compile_s = _build_seconds(dev)
    t0 = _fence(dev)
    planes = _rows(0, n, seed, 1, dev)
    shi, slo, spay = sort_planes([planes[1], planes[0], planes[2]], 2)
    del planes
    s_ok, h_ok, _, psum, psq = _certify(slo, shi, spay, (), n,
                                        seed)[:5].tolist()
    dt = _fence(dev) - t0
    return BigSortResult(
        n=n, seconds=dt, keys_per_s=n / dt, sorted_ok=bool(s_ok),
        hash_ok=bool(h_ok), count_ok=True,
        perm_ok=(psum, psq) == _want_sums(n), boundary_ok=True,
        phase_a_s=0.0, phase_c_s=dt, compile_s=compile_s)


def _sorted_run(r, run_size, seed, payload_cols, dev):
    """Merge strategy, phase A: run r sorted by key."""
    lo, hi, *rest = _rows(r * run_size, run_size, seed, payload_cols, dev)
    shi, slo, *srest = sort_planes([hi, lo, *rest], 2)
    return [slo, shi, *srest]


def _bucketed_run(r, sp, run_size, seed, payload_cols, n_buckets, dev):
    """Partition strategy, phase A: run r grouped by destination bucket
    (the count of splitters <= key) with one stable sort of the bucket id;
    returns the run's planes and its (B-1,) segment boundaries."""
    planes = _rows(r * run_size, run_size, seed, payload_cols, dev)
    bid = searchsorted_u64(sp, U64(planes[0], planes[1]), side="right")
    bits = max(1, (n_buckets - 1).bit_length())
    sbid, *out = sort_planes([narrow(bid)] + planes, 1, key_bits=[bits])
    bounds = torch.searchsorted(
        widen(sbid), torch.arange(1, n_buckets, device=dev), side="left")
    return out, bounds


def _splitters(lo, hi, n_buckets) -> U64:
    """(B-1,) splitters at the bucket quantiles of sample keys."""
    s_hi, s_lo = sort_planes([hi, lo], 2)
    total = s_lo.shape[0]
    q = torch.arange(1, n_buckets, device=lo.device) * total // n_buckets
    return U64(s_lo[q], s_hi[q])


def _plan_from_generator(n_runs, run_size, per_run, n_buckets, seed,
                         dev) -> U64:
    """Partition strategy, phase B: splitters from generated samples, before
    any run exists (keys are a hash of the index)."""
    stride = max(run_size // per_run, 1)
    sel = torch.arange(per_run, device=dev) * stride % run_size
    idx = narrow(torch.cat([r * run_size + sel for r in range(n_runs)]))
    key = keygen_hash(idx, seed)
    return _splitters(key.lo, key.hi, n_buckets)


def _plan_from_runs(runs, n_buckets, per_run) -> np.ndarray:
    """Merge strategy, phase B: splitters from strided samples of the
    sorted runs, and each run's segment boundaries (R, B-1)."""
    los, his = [], []
    for run in runs:
        n = run[0].shape[0]
        sel = torch.arange(per_run, device=run[0].device) * max(
            n // per_run, 1) % n
        los.append(run[0][sel])
        his.append(run[1][sel])
    sp = _splitters(torch.cat(los), torch.cat(his), n_buckets)
    return torch.stack([searchsorted_u64(U64(run[0], run[1]), sp,
                                         side="left") for run in runs])


def _merge_bucket(runs, starts, ends, cap_seg, seed):
    """Phase C for one bucket: (scalars, sorted planes, valid count). The
    segments [starts[r], ends[r]) of every run are concatenated in run
    order, then sentinel rows (all-ones key, zero payloads) fill the
    capacity n_runs * cap_seg."""
    n_runs = len(runs)
    n_valid = int(sum(int(e) - int(s) for s, e in zip(starts, ends)))
    m = n_runs * cap_seg
    cols = []
    for c in range(len(runs[0])):
        parts = [runs[r][c][int(starts[r]):int(ends[r])]
                 for r in range(n_runs)]
        parts.append(torch.full((m - n_valid,), -1 if c < 2 else 0,
                                dtype=torch.int32, device=runs[0][c].device))
        cols.append(torch.cat(parts))
    shi, slo, spay, *svals = sort_planes([cols[1], cols[0], *cols[2:]], 2)
    del cols
    return (_certify(slo, shi, spay, svals, n_valid, seed),
            (slo, shi, spay, *svals), n_valid)


def sort_big(n: int, run_size: int = 1 << 26, n_buckets: int | None = None,
             seed: int = 7, samples_per_run: int = 4096,
             verbose: bool = False, collect: bool = False,
             checkpoint_dir: str | None = None, consume=None,
             payload_cols: int = 1, strategy: str = "partition",
             device: str | torch.device = "cuda"):
    """Device-resident out-of-core sort of n generated rows, with full
    verification (module docstring); on the card unless `device` names
    another.

    n must be a multiple of run_size. payload_cols: u32 payload columns
    per row (>= 1); column 1 is the unique global index, columns 2..P
    carried value columns, each verified on the device against its row's
    index. consume(b, bucket): called per bucket in global key order with
    device tensors: key (U64, sorted), payload (the index), values, count
    (valid rows; rows past it are sentinels). checkpoint_dir: persist the
    splitter plan and each bucket's scalars (utils/checkpoint.RunState); a
    killed run resumes with phase A regenerated, the plan loaded and
    completed buckets replaying their scalars. collect=True (tests) also
    returns the sorted keys, payloads (and value columns) as numpy
    arrays; with a checkpoint it re-merges completed buckets. strategy:
    "partition" (splitters first, one bucket-id sort per run, one key sort
    per bucket) or "merge" (every run sorted, splitters from the runs,
    one key sort per bucket); the output is the same.
    """
    assert strategy in ("partition", "merge"), strategy
    assert n % run_size == 0, (n, run_size)
    assert n < (1 << 32), "payload travels as u32 global index"
    assert payload_cols >= 1, payload_cols
    dev = resolve_device(device)
    n_runs = n // run_size
    if n_buckets is None:
        n_buckets = max(2, int(np.ceil(n / (1 << 26))))
    meta = np.asarray([n, run_size, n_buckets, seed, samples_per_run,
                       payload_cols, 0 if strategy == "merge" else 1],
                      dtype=np.int64)
    state = (RunState.load(checkpoint_dir, meta)
             if checkpoint_dir is not None else None)
    compile_s = _build_seconds(dev)

    t_b = 0.0
    if strategy == "partition":
        t0 = _fence(dev)
        sp = _plan_from_generator(n_runs, run_size, samples_per_run,
                                  n_buckets, seed, dev)
        t_b = _fence(dev) - t0
    t0 = _fence(dev)
    runs, bound_devs = [], []
    with span("bigsort phase A: run formation"):
        for r in range(n_runs):
            if strategy == "partition":
                run, bounds = _bucketed_run(r, sp, run_size, seed,
                                            payload_cols, n_buckets, dev)
                bound_devs.append(bounds)
            else:
                run = _sorted_run(r, run_size, seed, payload_cols, dev)
            runs.append(run)
    t_a = _fence(dev) - t0

    # a resumed run reuses the persisted plan: completed buckets are only
    # meaningful against the boundaries they were merged with
    if state is not None:
        bounds = state.bounds
        if strategy != "partition":
            t_b = 0.0
    else:
        t0 = _fence(dev)
        bounds_dev = (torch.stack(bound_devs) if strategy == "partition"
                      else _plan_from_runs(runs, n_buckets, samples_per_run))
        bounds = bounds_dev.cpu().numpy().astype(np.int32)
        if strategy != "partition":
            t_b = _fence(dev) - t0
        if checkpoint_dir is not None:
            state = RunState.fresh(checkpoint_dir, meta, bounds, n_buckets)
    starts = np.concatenate([np.zeros((n_runs, 1), bounds.dtype), bounds],
                            axis=1).astype(np.int64)            # (R, B)
    ends = np.concatenate([bounds, np.full((n_runs, 1), run_size,
                                           bounds.dtype)], axis=1
                          ).astype(np.int64)
    sizes = ends - starts
    # the static segment capacity: the demand rounded up to 1M rows (256
    # for small runs), at most a run
    quantum = 1 << 20 if run_size >= (1 << 22) else 256
    cap_seg = min(-(-max(int(sizes.max()), 1) // quantum) * quantum,
                  run_size)
    if verbose:
        print(f"bigsort: {n_runs} runs x {run_size}, {n_buckets} buckets, "
              f"cap_seg={cap_seg} (max demand {int(sizes.max())})")

    emit = collect or consume is not None
    t1 = _fence(dev)
    scal = np.zeros((n_buckets, RunState.N_SCALARS), np.int64)
    skip = set()
    if state is not None and not emit:
        for b in range(n_buckets):
            if state.done[b]:
                scal[b] = state.scalars[b]
                skip.add(b)
        if verbose and skip:
            print(f"bigsort: resuming — {len(skip)}/{n_buckets} buckets "
                  "already merged")
    # each bucket's scalars are read back (and checkpointed) as soon as it
    # is merged, so a run killed at any point keeps every finished bucket
    collected = []
    with span("bigsort phase C: bucket merges"):
        for b in range(n_buckets):
            if b in skip:
                continue
            out, arrays, n_valid = _merge_bucket(
                runs, starts[:, b], ends[:, b], cap_seg, seed)
            if consume is not None:
                consume(b, dict(key=U64(arrays[0], arrays[1]),
                                payload=arrays[2], values=tuple(arrays[3:]),
                                count=torch.tensor(n_valid, device=dev)))
            if collect:
                collected.append([a[:n_valid].cpu().numpy().view(np.uint32)
                                  for a in arrays])
            del arrays
            vals = out.tolist()
            scal[b] = vals
            if state is not None:
                state.record(b, vals)
            if verbose:
                print(f"  bucket {b}: {scal[b, 2]} rows "
                      f"sorted={bool(scal[b, 0])} hash={bool(scal[b, 1])}")

    total_count, sum_pay, sum_sq = 0, 0, 0
    all_sorted = all_hash = boundary_ok = True
    prev_last = None
    for b in range(n_buckets):
        s_ok, h_ok, cnt, psum, psq, flo, fhi, llo, lhi = (int(v) for v in
                                                          scal[b])
        all_sorted &= bool(s_ok)
        all_hash &= bool(h_ok)
        total_count += cnt
        sum_pay = (sum_pay + psum) & U32_MASK
        sum_sq = (sum_sq + psq) & U32_MASK
        if prev_last is not None and cnt > 0:
            boundary_ok &= prev_last <= (fhi, flo)
        if cnt > 0:
            prev_last = (lhi, llo)
    t_c = _fence(dev) - t1

    # permutation evidence: with the counts and every row's hash, the sums
    # pin the output to a permutation of the generated rows
    dt = t_a + t_b + t_c
    res = BigSortResult(
        n=n, seconds=dt, keys_per_s=n / dt, sorted_ok=all_sorted,
        hash_ok=all_hash, count_ok=total_count == n,
        perm_ok=(sum_pay, sum_sq) == _want_sums(n),
        boundary_ok=boundary_ok, phase_a_s=t_a, phase_c_s=t_c,
        compile_s=compile_s)
    if collect:
        lo, hi, pay = (np.concatenate([c[i] for c in collected])
                       for i in range(3))
        keys = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
        if payload_cols > 1:
            return res, (keys, pay, tuple(
                np.concatenate([c[3 + j] for c in collected])
                for j in range(payload_cols - 1)))
        return res, (keys, pay)
    return res
