"""Out-of-core GROUP BY over more rows than one program sorts: the port of
tpu_qe/ops/bigagg.py.

  phase A   per run of `run_size` rows: generate the rows on the device
            (group = a hash of the row index mod n_groups, value = the
            index) and aggregate the run with ``group_aggregate``; only
            the run's partial group table (key, count, exact u64 sum
            pair[, min, max]) stays, padded to partial_cap =
            min(n_groups, run_size) rows with all-ones keys and zero
            counts and sums (min / max padded with their identities);
  phase B   one combine: the R partial tables concatenated, sorted by
            key, equal keys merged (counts by int64 prefix differences;
            sums by the exact u64 prefix sum mod 2^64, as the reference's
            pair cumsum with wrap carries), group ends moved to the front,
            and verified on the device: total count == n, total value sum
            == n(n-1)/2 (+ n*c for column c of the multi shape), group keys
            strictly ascending. Only scalars cross to the host.

Every sort is ``sort_planes`` (the B1-B3 radix kernels on the card). The
reference's compaction sort of packed positions is ``stable_partition``,
as in the in-core port; its unstable key sort of the combine becomes a
stable one, and the answer does not depend on the order of tied rows.

Row indices are int64 (a row index may pass 2^31 for n < 2^32) and are
narrowed to u32 bit patterns only for the hash and the value column. The
partial tables are int32 planes of u32 bit patterns, so a run table
written by either package's checkpoint (`bigagg_run{r}.npz`) loads in the
other. Phases are fenced with torch.cuda.synchronize(); `compile_s` is the
time the CUDA kernels took to build at first use (0 when built, and on
the CPU).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from tpu_qe_torch.bits import U32_MASK, U64, narrow, widen
from tpu_qe_torch.config import resolve_device
from tpu_qe_torch.hashing import murmur_fmix32, murmur_fmix32_numpy
from tpu_qe_torch.ops.aggregate import (_diff_u64, _shift_right_one,
                                        group_aggregate,
                                        group_aggregate_multi,
                                        segmented_reduce)
from tpu_qe_torch.ops.filter import stable_partition
from tpu_qe_torch.ops.segscan import cumsum_u64_pair
from tpu_qe_torch.sort.bigsort import _build_seconds, _fence
from tpu_qe_torch.sort.planes import sort_planes
from tpu_qe_torch.utils.profiling import span

_GSALT = 0x9E3779B9
_ONES = -1                  # all-ones u32 as an int32 plane value


def _const(x: int) -> int:
    """A u32 constant as the int32 value with its bits."""
    x &= U32_MASK
    return x - (1 << 32) if x >> 31 else x


def _group_of_index(idx: torch.Tensor, n_groups: int, seed: int):
    """Group id in [0, n_groups) of int64 row indices (int32 plane)."""
    h = murmur_fmix32(narrow(idx) ^ _const(_GSALT + seed))
    return narrow(widen(h) % n_groups)


def group_of_index_numpy(idx: np.ndarray, n_groups: int,
                         seed: int = 7) -> np.ndarray:
    """Numpy mirror of _group_of_index (for oracle tests)."""
    h = idx.astype(np.uint32) ^ np.uint32((_GSALT + seed) & U32_MASK)
    return (murmur_fmix32_numpy(h).astype(np.uint64)
            % np.uint64(n_groups)).astype(np.uint32)


def _run_index(r: int, run_size: int, device) -> torch.Tensor:
    """Global int64 row indices of run r."""
    return torch.arange(r * run_size, (r + 1) * run_size, device=device)


def _cut(a: torch.Tensor, valid: torch.Tensor, fill: int) -> torch.Tensor:
    """The first len(valid) rows of int32 plane `a`, `fill` past them."""
    return torch.where(valid, a[:valid.shape[0]], fill)


def _aggregate_rows(idx: torch.Tensor, n_groups: int, seed: int,
                    partial_cap: int, minmax: bool):
    """Aggregate the rows of int64 indices `idx` into the padded partial
    group table (klo, khi, cnt, slo, shi[, vmin, vmax]) of int32 planes:
    all-ones keys, zero counts and sums past the groups, min / max padded
    with their identities so that the combine folds them harmlessly."""
    g = _group_of_index(idx, n_groups, seed)
    aggs = ("count", "sum") + (("min", "max") if minmax else ())
    res = group_aggregate(U64(g, torch.zeros_like(g)),
                          narrow(idx).view(torch.uint32), aggs=aggs)
    valid = torch.arange(partial_cap, device=idx.device) < res.num_groups
    s = res.aggs["sum"]
    out = (_cut(res.key.lo, valid, _ONES), _cut(res.key.hi, valid, _ONES),
           _cut(narrow(res.aggs["count"]), valid, 0),
           _cut(s.lo, valid, 0), _cut(s.hi, valid, 0))
    if minmax:
        out += (_cut(res.aggs["min"].view(torch.int32), valid, _ONES),
                _cut(res.aggs["max"].view(torch.int32), valid, 0))
    return out


def _partial_run(r: int, run_size: int, n_groups: int, seed: int,
                 partial_cap: int, minmax: bool, device):
    """One phase-A step: generate run r, aggregate it."""
    return _aggregate_rows(_run_index(r, run_size, device), n_groups, seed,
                           partial_cap, minmax)


def _u32(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy().view(np.uint32)


def _host_table(cols, minmax: bool):
    """The collect=True host group table from emitted planes."""
    cols = [_u32(x) for x in cols]
    gk, gc, gl, gh = cols[:4]
    keep = gc > 0
    table = {
        "key": gk[keep],
        "count": gc[keep],
        "sum": (gh[keep].astype(np.uint64) << np.uint64(32))
        | gl[keep].astype(np.uint64),
    }
    if minmax:
        table["min"] = cols[4][keep]
        table["max"] = cols[5][keep]
    return table


def _merge_partials(cols, n_sums: int = 1):
    """Merge rows of sentinel-padded partial group tables, group ends
    compacted to the front.

    cols: (klo, khi, cnt, slo_0, shi_0, ..., slo_{n_sums-1},
    shi_{n_sums-1}[, vmin, vmax]) int32 planes. Counts fold by int64 prefix
    differences (the count total is n < 2^32), each sum column by the
    u64 prefix sum mod 2^64, min / max by segmented scans.

    Returns (gklo, gkhi, gcnt, gsums: tuple[U64], gmin, gmax, gvalid) with
    invalid rows not yet masked; gcnt is int64; gmin / gmax are None
    without min / max planes.
    """
    m = cols[0].shape[0]
    base = 3 + 2 * n_sums
    minmax = len(cols) == base + 2
    assert len(cols) in (base, base + 2), (len(cols), n_sums)
    skhi, sklo, scnt, *rest = sort_planes([cols[1], cols[0], *cols[2:]], 2)
    idx = torch.arange(m, device=sklo.device)
    is_new = ((idx == 0) | (sklo != _shift_right_one(sklo, 0))
              | (skhi != _shift_right_one(skhi, 0)))
    is_end = torch.cat([is_new[1:], torch.ones(1, dtype=torch.bool,
                                               device=is_new.device)])
    order = stable_partition(is_end)
    ccnt = torch.cumsum(widen(scnt), 0)[order]
    gcnt = ccnt - _shift_right_one(ccnt, 0)
    gsums = []
    for j in range(n_sums):
        plo, phi = cumsum_u64_pair(rest[2 * j], rest[2 * j + 1])
        gsums.append(_diff_u64(plo[order], phi[order]))
    gmin = gmax = None
    if minmax:
        # cross-table group min / max: segmented running min / max over the
        # key-sorted rows, read at group-end rows
        gmin = segmented_reduce(rest[-2].view(torch.uint32), is_new,
                                "min").view(torch.int32)[order]
        gmax = segmented_reduce(rest[-1].view(torch.uint32), is_new,
                                "max").view(torch.int32)[order]
    n_all = is_end.sum()                     # incl. the sentinel group
    gvalid = (idx < n_all) & (gcnt > 0)
    return sklo[order], skhi[order], gcnt, tuple(gsums), gmin, gmax, gvalid


def _verify_and_emit(merged, collect: bool, minmax: bool):
    """Verification on the device and the output over a merged table.

    Returns (scalars, planes): scalars is the list of Python ints
    num_groups, total_cnt, then (tlo, thi) per sum column, then
    keys_sorted, minmax_ok, read back in one transfer; planes (collect
    only) are the int32 planes key, count, per column (slo, shi)[, min,
    max], zero (key: all ones) past the groups."""
    gklo, gkhi, gcnt, gsums, gmin, gmax, gvalid = merged
    dev = gklo.device
    num_groups = gvalid.sum()
    total_cnt = torch.where(gvalid, gcnt, 0).sum() & U32_MASK
    totals = []
    for gsum in gsums:
        # the u64 total mod 2^64 (int64 sums wrap the same way)
        t = torch.where(gvalid, widen(gsum.lo) + (gsum.hi.to(torch.int64)
                                                  << 32), 0).sum()
        totals += [t & U32_MASK, (t >> 32) & U32_MASK]
    kl, kh = widen(gklo), widen(gkhi)
    gt = (kh[1:] > kh[:-1]) | ((kh[1:] == kh[:-1]) & (kl[1:] > kl[:-1]))
    keys_sorted = (gt | ~gvalid[1:]).all()      # strict: unique keys
    if minmax:
        # values are the global row indices 0..n-1, so min-of-mins == 0,
        # max-of-maxes == n-1, and every group's min <= max
        lo, hi = widen(gmin), widen(gmax)
        mm_ok = ((~gvalid | (lo <= hi)).all()
                 & (torch.where(gvalid, lo, U32_MASK).min() == 0)
                 & (torch.where(gvalid, hi, 0).max()
                    == ((total_cnt - 1) & U32_MASK)))
    else:
        mm_ok = torch.ones((), dtype=torch.bool, device=dev)
    scalars = torch.stack([num_groups, total_cnt, *totals,
                           keys_sorted.to(torch.int64),
                           mm_ok.to(torch.int64)]).tolist()
    if not collect:
        return scalars, ()
    out = (torch.where(gvalid, gklo, _ONES),
           torch.where(gvalid, narrow(gcnt), 0))
    for gsum in gsums:
        out += (torch.where(gvalid, gsum.lo, 0),
                torch.where(gvalid, gsum.hi, 0))
    if minmax:
        out += (torch.where(gvalid, gmin, 0), torch.where(gvalid, gmax, 0))
    return scalars, out


def _combine(parts, collect: bool, minmax: bool, n_sums: int = 1):
    """Phase B: merge R partial tables, verify on the device.

    parts: (klo, khi, cnt, (slo, shi) per sum column[, vmin, vmax]) int32
    planes per run."""
    m = sum(p[0].shape[0] for p in parts)
    assert m < (1 << 28), ("combine exceeds the in-core cap; bucket the "
                           "partials (see module docstring)", m)
    cols = tuple(torch.cat([p[i] for p in parts])
                 for i in range(len(parts[0])))
    return _verify_and_emit(_merge_partials(cols, n_sums), collect, minmax)


def _partial_run_multi(r: int, run_size: int, n_groups: int, seed: int,
                       partial_cap: int, value_cols: int, device):
    """Phase-A step of the multi-column shape: one key sort shared by all
    value columns (group_aggregate_multi); emits (klo, khi, cnt, slo_0,
    shi_0, ..., slo_{V-1}, shi_{V-1}) padded as _aggregate_rows pads."""
    idx = _run_index(r, run_size, device)
    g = _group_of_index(idx, n_groups, seed)
    values = {f"v{c}": narrow(idx + c).view(torch.uint32)
              for c in range(value_cols)}
    aggs = {f"v{c}": (("count", "sum") if c == 0 else ("sum",))
            for c in range(value_cols)}
    res = group_aggregate_multi(U64(g, torch.zeros_like(g)), values, aggs)
    valid = torch.arange(partial_cap, device=device) < res.num_groups
    out = (_cut(res.key.lo, valid, _ONES), _cut(res.key.hi, valid, _ONES),
           _cut(narrow(res.aggs["v0_count"]), valid, 0))
    for c in range(value_cols):
        s = res.aggs[f"v{c}_sum"]
        out += (_cut(s.lo, valid, 0), _cut(s.hi, valid, 0))
    return out


@dataclasses.dataclass(frozen=True)
class BigAggResult:
    n: int
    n_groups: int              # groups found (count > 0)
    seconds: float
    rows_per_s: float
    count_ok: bool             # sum of group counts == n
    sum_ok: bool               # total u64 value sum == n(n-1)/2
    keys_ok: bool              # group keys strictly ascending (unique)
    groups_ok: bool            # group count within the structural bound
    phase_a_s: float
    phase_b_s: float
    compile_s: float = 0.0
    minmax_ok: bool = True     # min <= max per group, global min 0 / max
    #   n-1 (true unless minmax aggregation was requested)

    @property
    def all_ok(self) -> bool:
        return (self.count_ok and self.sum_ok and self.keys_ok
                and self.groups_ok and self.minmax_ok)


def aggregate_big_multi(n: int, n_groups: int = 1 << 20,
                        run_size: int = 1 << 26, value_cols: int = 4,
                        seed: int = 7, verbose: bool = False,
                        collect: bool = False,
                        device: str | torch.device = "cuda"):
    """Multi-column out-of-core GROUP BY (SELECT count(*), sum(v0), ...,
    sum(v{V-1}) GROUP BY key): the V columns share each run's one key sort
    and the combine's one merge; on the card unless `device` names
    another.

    Row i: column c's value is i + c, so every column total is closed
    form: sum_c == n(n-1)/2 + n*c, checked per column. collect=True also
    returns dict(key, count, sum0..sum{V-1}) (oracle tests).
    """
    assert n % run_size == 0, (n, run_size)
    assert n + value_cols < (1 << 32), "values travel as u32 index + c"
    assert value_cols >= 1
    dev = resolve_device(device)
    n_runs = n // run_size
    partial_cap = min(n_groups, run_size)
    compile_s = _build_seconds(dev)

    t0 = _fence(dev)
    with span("bigagg phase A: partial runs"):
        parts = [_partial_run_multi(r, run_size, n_groups, seed,
                                    partial_cap, value_cols, dev)
                 for r in range(n_runs)]
    t_a = _fence(dev) - t0

    t1 = _fence(dev)
    with span("bigagg phase B: combine"):
        scal, planes = _combine(tuple(parts), collect, False, value_cols)
    t_b = _fence(dev) - t1
    ng, total_cnt, ks = scal[0], scal[1], scal[-2]
    sums_ok = all(
        ((scal[3 + 2 * c] << 32) | scal[2 + 2 * c])
        == n * (n - 1) // 2 + n * c
        for c in range(value_cols))
    dt = t_a + t_b
    res = BigAggResult(
        n=n, n_groups=ng, seconds=dt, rows_per_s=n / dt,
        count_ok=(total_cnt == n), sum_ok=sums_ok, keys_ok=bool(ks),
        groups_ok=(ng <= min(n_groups, n)),
        phase_a_s=t_a, phase_b_s=t_b, compile_s=compile_s)
    if verbose:
        print(f"bigagg-multi: n={n} V={value_cols} R={n_runs} "
              f"G={n_groups} groups={ng} A={t_a:.2f}s B={t_b:.2f}s "
              f"ok={res.all_ok}")
    if collect:
        cols = [_u32(x) for x in planes]
        gk, gc = cols[0], cols[1]
        keep = gc > 0
        table = {"key": gk[keep], "count": gc[keep]}
        for c in range(value_cols):
            lo, hi = cols[2 + 2 * c], cols[3 + 2 * c]
            table[f"sum{c}"] = (hi[keep].astype(np.uint64)
                                << np.uint64(32)) | lo[keep].astype(
                np.uint64)
        return res, table
    return res


def _run_ck_path(directory: str, r: int) -> str:
    return os.path.join(directory, f"bigagg_run{r}.npz")


def _run_ck_load(directory: str, r: int, meta: np.ndarray,
                 device: str | torch.device = "cuda"):
    """Run r's persisted partial table as int32 planes on `device`, if it
    is there and matches this configuration."""
    p = _run_ck_path(directory, r)
    if not os.path.exists(p):
        return None
    with np.load(p) as z:
        if not np.array_equal(z["meta"], meta):
            return None
        return tuple(torch.from_numpy(np.ascontiguousarray(
            z[f"c{i}"], dtype=np.uint32).view(np.int32)).to(device)
            for i in range(int(z["ncols"])))


def _run_ck_save(directory: str, r: int, meta: np.ndarray, part) -> None:
    cols = {f"c{i}": _u32(a) for i, a in enumerate(part)}
    tmp = _run_ck_path(directory, r) + ".tmp.npz"
    np.savez(tmp, meta=meta, ncols=len(part), **cols)
    os.replace(tmp, _run_ck_path(directory, r))


def aggregate_big(n: int, n_groups: int = 1 << 20, run_size: int = 1 << 26,
                  seed: int = 7, verbose: bool = False,
                  collect: bool = False, minmax: bool = False,
                  checkpoint_dir: str | None = None,
                  device: str | torch.device = "cuda"):
    """Out-of-core GROUP BY count + sum (optionally min + max) of n rows
    generated on the device; on the card unless `device` names another.

    Row i: group key = hash(i) mod n_groups, value = i, so counts sum to n
    and the u64 value total is n(n-1)/2, both checked on the device
    (minmax adds per-group min <= max, global min 0 and max n-1).
    collect=True also returns the host group table dict(key, count,
    sum[, min, max]) in key order (oracle tests). checkpoint_dir: each
    run's partial table is written atomically after the run
    (`bigagg_run{r}.npz`, the reference's layout); a restarted run loads
    the matching tables and computes only the missing runs.
    """
    assert n % run_size == 0, (n, run_size)
    assert n < (1 << 32), "values travel as u32 global index"
    dev = resolve_device(device)
    n_runs = n // run_size
    partial_cap = min(n_groups, run_size)
    meta = np.asarray([n, n_groups, run_size, seed, int(minmax)], np.int64)
    compile_s = _build_seconds(dev)

    t0 = _fence(dev)
    parts, resumed = [], 0
    with span("bigagg phase A: partial runs"):
        for r in range(n_runs):
            part = (None if checkpoint_dir is None
                    else _run_ck_load(checkpoint_dir, r, meta, dev))
            if part is not None:
                resumed += 1
            else:
                part = _partial_run(r, run_size, n_groups, seed,
                                    partial_cap, minmax, dev)
                if checkpoint_dir is not None:
                    _run_ck_save(checkpoint_dir, r, meta, part)
            parts.append(part)
    if verbose and resumed:
        print(f"bigagg: resuming — {resumed}/{n_runs} run tables loaded "
              "from checkpoint")
    t_a = _fence(dev) - t0

    t1 = _fence(dev)
    with span("bigagg phase B: combine"):
        scal, planes = _combine(tuple(parts), collect, minmax)
    t_b = _fence(dev) - t1
    ng, total_cnt, tlo, thi, ks, mm = scal
    dt = t_a + t_b
    res = BigAggResult(
        n=n, n_groups=ng, seconds=dt, rows_per_s=n / dt,
        count_ok=(total_cnt == n),
        sum_ok=((thi << 32) | tlo) == n * (n - 1) // 2,
        keys_ok=bool(ks), groups_ok=(ng <= min(n_groups, n)),
        phase_a_s=t_a, phase_b_s=t_b, compile_s=compile_s,
        minmax_ok=bool(mm))
    if verbose:
        print(f"bigagg: n={n} R={n_runs} G={n_groups} "
              f"partial_cap={partial_cap} groups={ng} "
              f"A={t_a:.2f}s B={t_b:.2f}s ok={res.all_ok}")
    if collect:
        return res, _host_table(planes, minmax)
    return res
