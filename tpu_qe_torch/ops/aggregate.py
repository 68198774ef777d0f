"""Sort-based GROUP BY aggregation: the port of tpu_qe/ops/aggregate.py.

Rows are sorted by group key (``sort_planes``: the radix kernels on the
card), group boundaries are found, and each run is reduced:

- count: difference of row positions at group-end rows;
- integer sum: exact u64 (lo, hi) pair from a u64 prefix sum;
- float sum: per-segment inclusive scan in the JAX package's blocked order
  (ops/segscan.py), so the float32 sums come out bit-identical;
- min / max: first / last row of each run after sorting by (key, value
  bits), or segmented scans where values are not sort keys;
- count_distinct: a (key OR value)-boundary count differenced at group
  ends.

Group-end rows move to the front with a stable partition (the JAX
package's packed-position compaction sort gives the same order).

Where the JAX package sorts by the value as well but the aggregates do not
depend on the row order inside a group (count and integer sums), the port
leaves the value out of the sort key: the results are the same bits, and a
2^28-row filter + GROUP BY saves four of its 13 radix passes.

Conventions of the port: counts, group counts and positions are int64
tensors (num_groups and overflow 0-d); value results keep the column's
dtype; u64 sums are U64 planes.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from tpu_qe_torch.bits import (U64, narrow, sortable_u32,
                               sortable_u32_inverse, widen)
from tpu_qe_torch.ops.filter import stable_partition
from tpu_qe_torch.ops.segscan import (cummax_int64, cumsum_u64_pair,
                                      scan_assoc)
from tpu_qe_torch.sort.planes import argsort_planes
from tpu_qe_torch.table import from_plane, plane, take_column
from tpu_qe_torch.utils.profiling import span

_VALID_AGGS = ("count", "sum", "min", "max", "count_distinct")
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


class GroupResult(NamedTuple):
    """Padded GROUP BY result: the first `num_groups` rows are valid."""

    key: U64                  # unique group keys, ascending
    aggs: dict                # agg name -> tensor (padded like key)
    num_groups: torch.Tensor  # 0-d int64 (exact, even past max_groups)
    overflow: torch.Tensor | None = None  # 0-d int64, only with max_groups


def _shift_right_one(x: torch.Tensor, fill) -> torch.Tensor:
    return torch.cat([torch.full((1,), fill, dtype=x.dtype, device=x.device),
                      x[:-1]])


def _ends(flags: torch.Tensor) -> torch.Tensor:
    """flags shifted left by one row, True after the last."""
    return torch.cat([flags[1:], torch.ones(1, dtype=torch.bool,
                                            device=flags.device)])


def _fill(col: torch.Tensor, mask: torch.Tensor, value) -> torch.Tensor:
    """col where mask, else the scalar `value` (in the column's dtype)."""
    if col.dtype == torch.float32:
        return torch.where(mask, col, float(value))
    fill = narrow(torch.tensor(value, dtype=torch.int64)).item()
    return from_plane(torch.where(mask, plane(col), fill), col.dtype)


def _identity(kind: str, dtype: torch.dtype):
    if kind == "sum":
        return 0
    if dtype == torch.float32:
        return float("inf") if kind == "min" else float("-inf")
    if dtype == torch.uint32:
        return 0xFFFFFFFF if kind == "min" else 0
    return _INT32_MAX if kind == "min" else _INT32_MIN


def segmented_reduce(values: torch.Tensor, is_new: torch.Tensor,
                     kind: str) -> torch.Tensor:
    """Inclusive per-segment running reduction (scan with segment reset):
    at each row the reduction of its segment up to and including itself.
    kind in {"min", "max", "sum"}; values are u32 / i32 / f32 columns
    (u32 compared unsigned) and the result keeps their dtype. Runs the
    blocked scan of ops/segscan.py over the (segment-start flag, value)
    monoid, so float sums associate as in JAX."""
    ops = {"min": torch.minimum, "max": torch.maximum,
           "sum": lambda a, b: a + b}
    op = ops[kind]
    if values.dtype == torch.float32:
        v = values
    elif values.dtype == torch.uint32:
        v = widen(plane(values))
    else:
        v = values.to(torch.int64)

    def combine(a, b):
        fa, va = a
        fb, vb = b
        return (fa | fb, torch.where(fb, vb, op(va, vb)))

    _, out = scan_assoc(combine, (False, _identity(kind, values.dtype)),
                        (is_new, v))
    if values.dtype == torch.float32:
        return out
    return from_plane(narrow(out), values.dtype)


def _diff_u64(end_lo: torch.Tensor, end_hi: torch.Tensor) -> U64:
    """Adjacent u64 differences with borrow over (lo, hi) planes: pair[i] -
    pair[i-1] (pair[-1] = 0), exact per-group sums from prefix sums at
    group-end rows."""
    lo, hi = widen(end_lo), widen(end_hi)
    plo, phi = _shift_right_one(lo, 0), _shift_right_one(hi, 0)
    borrow = (lo < plo).to(torch.int64)
    return U64(narrow(lo - plo), narrow(hi - phi - borrow))


def segmented_sum_u64(vlo: torch.Tensor, vhi: torch.Tensor,
                      is_new: torch.Tensor):
    """Inclusive per-segment u64 sum of (lo, hi) planes, resetting at
    segment starts; returns (lo, hi) int32 planes."""

    def combine(a, b):
        fa, la, ha = a
        fb, lb, hb = b
        s = la + lb
        return (fa | fb, torch.where(fb, lb, s & 0xFFFFFFFF),
                torch.where(fb, hb, (ha + hb + (s >> 32)) & 0xFFFFFFFF))

    _, lo, hi = scan_assoc(combine, (False, 0, 0),
                           (is_new, widen(vlo), widen(vhi)))
    return narrow(lo), narrow(hi)


def _mean(res, aggs):
    s, c = res.aggs["sum"], res.aggs["count"]
    if isinstance(s, U64):   # exact integer pair sum -> float32
        sf = (widen(s.hi).to(torch.float32) * float(2 ** 32)
              + widen(s.lo).to(torch.float32))
    else:
        sf = s
    mean = sf / torch.clamp(c, min=1).to(torch.float32)
    out = {a: res.aggs[a] for a in aggs if a != "mean"}
    out["mean"] = mean
    return GroupResult(res.key, out, res.num_groups, res.overflow)


def _with_mean_inputs(aggs):
    return tuple(dict.fromkeys([a for a in aggs if a != "mean"]
                               + ["sum", "count"]))


def _check_aggs(aggs, value):
    for a in aggs:
        if a not in _VALID_AGGS:
            raise ValueError(f"unknown agg {a!r}")
    if any(a != "count" for a in aggs) and value is None:
        raise ValueError("value column required for sum/min/max")


def _empty(aggs, value, pad_n, dev, max_groups):
    z32 = torch.zeros(pad_n, dtype=torch.int32, device=dev)
    z64 = torch.zeros(pad_n, dtype=torch.int64, device=dev)

    def empty(a):
        if a in ("count", "count_distinct") or value is None:
            return z64
        if a == "sum" and value.dtype != torch.float32:
            return U64(z32, z32)
        return from_plane(z32, value.dtype)

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return GroupResult(U64(z32, z32), {a: empty(a) for a in aggs}, zero,
                       zero if max_groups is not None else None)


def _sort_by_key(key: U64, valid, value_bits, backend):
    """Rows sorted by (invalid flag, key[, value bits]), invalid rows last:
    (slo, shi, sorted invalid flags or None, sorted value bits or None,
    perm)."""
    keys, bits = [key.hi, key.lo], [32, 32]
    if valid is not None:
        keys, bits = [(~valid).to(torch.int32)] + keys, [1] + bits
    if value_bits is not None:
        keys, bits = keys + [value_bits], bits + [32]
    skeys, perm = argsort_planes(keys, bits, backend)
    sinvalid = None
    if valid is not None:
        sinvalid = skeys.pop(0) != 0
    sval_bits = skeys[2] if value_bits is not None else None
    return skeys[1], skeys[0], sinvalid, sval_bits, perm


def _boundaries(slo, shi, sinvalid):
    n = slo.shape[0]
    idx = torch.arange(n, device=slo.device)
    is_new = ((idx == 0) | (slo != _shift_right_one(slo, 0))
              | (shi != _shift_right_one(shi, 0)))
    if sinvalid is None:
        return is_new, _ends(is_new)
    # invalid rows sorted to the tail start no group; a valid row ends its
    # group iff the next row starts one, is invalid, or is the end
    is_new = is_new & ~sinvalid
    return is_new, ~sinvalid & _ends(is_new | sinvalid)


def _extract(is_end, max_groups):
    """Group-end positions of the max_groups path: a binary search of the
    inclusive end count for groups 1..max_groups."""
    n = is_end.shape[0]
    dev = is_end.device
    cum_end = torch.cumsum(is_end.to(torch.int64), 0)
    num_groups = cum_end[-1]
    overflow = (num_groups > max_groups).to(torch.int64)
    j1 = torch.arange(1, max_groups + 1, dtype=torch.int64, device=dev)
    posc = torch.clamp(torch.searchsorted(cum_end, j1), max=n - 1)
    valid_g = torch.arange(max_groups, device=dev) < num_groups
    pos_end = torch.where(valid_g, posc + 1, 0)
    return num_groups, overflow, posc, valid_g, pos_end


def group_aggregate(key: U64, value: torch.Tensor | None = None,
                    aggs: Sequence[str] = ("count",),
                    valid: torch.Tensor | None = None,
                    max_groups: int | None = None,
                    backend: str = "radix") -> GroupResult:
    """GROUP BY `key` computing `aggs` over `value`.

    value: u32 / i32 / f32 column. Integer "sum" is an exact U64 (i32
    values are summed as their u32 bit patterns, as in JAX); float "sum"
    float32 per-segment; "mean" float32 sum / count; "count_distinct"
    counts distinct value bit patterns (so -0.0 and +0.0, and NaNs of
    other payloads, are distinct). valid: optional bool mask; rows where
    it is False are excluded through the sort (invalid rows sort last).
    max_groups: pad outputs to max_groups and extract group ends by binary
    search; num_groups stays exact and overflow is 1 past the bound.
    Traced as ops.group, with its device time.
    """
    aggs = tuple(aggs)
    with span("ops.group", device=key.lo.device):
        if "mean" in aggs:
            res = _group_aggregate(key, value, _with_mean_inputs(aggs),
                                   valid, max_groups, backend)
            return _mean(res, aggs)
        return _group_aggregate(key, value, aggs, valid, max_groups,
                                backend)


def _group_aggregate(key, value, aggs, valid, max_groups, backend):
    _check_aggs(aggs, value)
    n = key.lo.shape[0]
    dev = key.lo.device
    if n == 0:
        return _empty(aggs, value, max_groups or 0, dev, max_groups)
    value_is_key = value is not None and (
        any(a in aggs for a in ("min", "max", "count_distinct"))
        or ("sum" in aggs and value.dtype == torch.float32))
    slo, shi, sinvalid, sval_bits, perm = _sort_by_key(
        key, valid, sortable_u32(value) if value_is_key else None, backend)
    sval = None
    if value_is_key:
        sval = sortable_u32_inverse(sval_bits, value.dtype)
    elif "sum" in aggs:
        sval = take_column(value, perm)

    is_new, is_end = _boundaries(slo, shi, sinvalid)
    seg_start = is_new if sinvalid is None else (is_new | sinvalid)
    if "count_distinct" in aggs:
        # rows are (key, value-bits)-sorted: a distinct value starts where
        # the group starts or the sorted bit plane changes
        pair_new = is_new | (sval_bits != _shift_right_one(sval_bits, 0))
        if sinvalid is not None:
            pair_new = pair_new & ~sinvalid
        cum_nd = torch.cumsum(pair_new.to(torch.int64), 0)
    float_sum = "sum" in aggs and sval.dtype == torch.float32

    if max_groups is not None:
        assert max_groups >= 1
        num_groups, overflow, posc, valid_g, pos_end = _extract(is_end,
                                                                max_groups)
        klo = torch.where(valid_g, slo[posc], -1)
        khi = torch.where(valid_g, shi[posc], -1)
        prev_pos = _shift_right_one(pos_end, 0)
        out = {}
        if "count" in aggs:
            out["count"] = torch.where(valid_g, pos_end - prev_pos, 0)
        if "sum" in aggs:
            if float_sum:
                csum = segmented_reduce(sval, seg_start, "sum")
                out["sum"] = torch.where(valid_g, csum[posc], 0.0)
            else:
                clo, chi = cumsum_u64_pair(plane(sval))
                s = _diff_u64(torch.where(valid_g, clo[posc], 0),
                              torch.where(valid_g, chi[posc], 0))
                out["sum"] = U64(torch.where(valid_g, s.lo, 0),
                                 torch.where(valid_g, s.hi, 0))
        if "max" in aggs:
            # rows are value-sorted within a group: the end row is the max
            out["max"] = _fill(take_column(sval, posc), valid_g, 0)
        if "min" in aggs:
            out["min"] = _fill(take_column(
                sval, torch.clamp(prev_pos, max=n - 1)), valid_g, 0)
        if "count_distinct" in aggs:
            cd = torch.where(valid_g, cum_nd[posc], 0)
            out["count_distinct"] = torch.where(
                valid_g, cd - _shift_right_one(cd, 0), 0)
        return GroupResult(U64(klo, khi), out, num_groups, overflow)

    order = stable_partition(is_end)
    pos_end = order + 1        # inclusive row count at each group end
    prev_pos = _shift_right_one(pos_end, 0)
    num_groups = is_end.sum(dtype=torch.int64)
    out = {}
    if "count" in aggs:
        out["count"] = pos_end - prev_pos
    if "sum" in aggs:
        if float_sum:
            # per-segment float sum: the value at a group-end row is the
            # group's sum
            out["sum"] = segmented_reduce(sval, seg_start, "sum")[order]
        else:
            clo, chi = cumsum_u64_pair(plane(sval))
            out["sum"] = _diff_u64(clo[order], chi[order])
    if "max" in aggs:
        out["max"] = take_column(sval, order)
    if "count_distinct" in aggs:
        cd_end = cum_nd[order]
        out["count_distinct"] = cd_end - _shift_right_one(cd_end, 0)
    if "min" in aggs:
        # a group's first row (its min) sits at the previous group's end
        out["min"] = take_column(sval, torch.clamp(prev_pos, max=n - 1))
    return GroupResult(U64(slo[order], shi[order]), out, num_groups)


def group_aggregate_sorted(key: U64, value: torch.Tensor | None = None,
                           aggs: Sequence[str] = ("count",),
                           valid: torch.Tensor | None = None) -> GroupResult:
    """GROUP BY over an already key-sorted stream (no input sort): the
    consumer of join_fk_scan(output="stream"). `valid` marks aggregated
    rows and may be interspersed; key runs with no valid row produce no
    group. min/max use segmented scans."""
    aggs = tuple(aggs)
    if "mean" in aggs:
        res = _group_aggregate_sorted(key, value, _with_mean_inputs(aggs),
                                      valid)
        return _mean(res, aggs)
    return _group_aggregate_sorted(key, value, aggs, valid)


def _group_aggregate_sorted(key, value, aggs, valid):
    _check_aggs(aggs, value)
    if "count_distinct" in aggs:
        raise ValueError("count_distinct requires the value-sorted path; "
                         "use group_aggregate")
    n = key.lo.shape[0]
    dev = key.lo.device
    if n == 0:
        return _empty(aggs, value, 0, dev, None)
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    slo, shi = key.lo, key.hi
    is_new, is_end = _boundaries(slo, shi, None)
    v = valid.to(torch.int64)
    vcnt = torch.cumsum(v, 0)
    # per-run inclusive valid count: forward-fill the before-run total
    base = cummax_int64(torch.where(is_new, vcnt - v, 0))
    run_count = vcnt - base
    keep = is_end & (run_count > 0)   # runs with no valid row drop out
    num_groups = keep.sum(dtype=torch.int64)
    order = stable_partition(keep)
    out = {}
    if "count" in aggs:
        out["count"] = run_count[order]
    if "sum" in aggs:
        if value.dtype == torch.float32:
            out["sum"] = segmented_reduce(_fill(value, valid, 0.0), is_new,
                                          "sum")[order]
        else:
            # masked exact u64 pair prefix: dropped runs add zero
            clo, chi = cumsum_u64_pair(torch.where(valid, plane(value), 0))
            out["sum"] = _diff_u64(clo[order], chi[order])
    for a in ("min", "max"):
        if a in aggs:
            mv = _fill(value, valid, _identity(a, value.dtype))
            out[a] = take_column(segmented_reduce(mv, is_new, a), order)
    return GroupResult(U64(slo[order], shi[order]), out, num_groups)


class MultiGroupResult(NamedTuple):
    """Padded multi-column GROUP BY result."""

    key: U64
    aggs: dict                # "column_agg" -> tensor (padded like key)
    num_groups: torch.Tensor
    overflow: torch.Tensor | None = None


def group_aggregate_multi(key: U64, values: dict, aggs: dict,
                          valid: torch.Tensor | None = None,
                          max_groups: int | None = None,
                          backend: str = "radix") -> MultiGroupResult:
    """Multi-column GROUP BY: one key sort shared by every aggregation.

    values: {column_name: u32/i32/f32 column}; aggs: {column_name: tuple of
    "count"/"sum"/"min"/"max"}. Value columns ride the sort as payloads;
    min/max come from segmented scans. Integer sums are exact U64: the u64
    sum of u32 columns, the two's-complement signed sum of i32 columns.
    Float sums difference a running cumsum, whose rounding depends on the
    row order inside a group (the JAX package's unstable sort leaves that
    order open; the port's sort keeps input order). Traced as ops.group,
    as group_aggregate.
    """
    with span("ops.group", device=key.lo.device):
        return _group_aggregate_multi(key, values, aggs, valid, max_groups,
                                      backend)


def _group_aggregate_multi(key, values, aggs, valid, max_groups, backend):
    names = tuple(sorted(values))
    for nm in names:
        for a in aggs.get(nm, ()):
            if a not in _VALID_AGGS:
                raise ValueError(f"unknown agg {a!r} for column {nm!r}")
            if a == "count_distinct":
                raise ValueError(
                    f"count_distinct on {nm!r}: unsupported in the "
                    "multi-column path; use group_aggregate per column")
    spec = [(nm, tuple(aggs[nm])) for nm in names if nm in aggs]
    n = key.lo.shape[0]
    dev = key.lo.device
    if n == 0:
        e = _empty((), None, max_groups or 0, dev, max_groups)
        out = {f"{nm}_{a}": v for nm, col_aggs in spec
               for a, v in _empty(col_aggs, values[nm], max_groups or 0, dev,
                                  max_groups).aggs.items()}
        return MultiGroupResult(e.key, out, e.num_groups, e.overflow)

    slo, shi, sinvalid, _, perm = _sort_by_key(key, valid, None, backend)
    is_new, is_end = _boundaries(slo, shi, sinvalid)

    # (out name, agg, dtype, planes): integer sums carry the (lo, hi) pair
    # prefix, counts nothing, the others one running plane
    reduced = []
    for nm, col_aggs in spec:
        v = take_column(values[nm], perm)
        for a in col_aggs:
            name = f"{nm}_{a}"
            if a == "count":
                reduced.append((name, a, v.dtype, []))
            elif a == "sum" and v.dtype == torch.float32:
                reduced.append((name, a, v.dtype, [torch.cumsum(v, 0)]))
            elif a == "sum" and v.dtype == torch.int32:
                # sign extension into the hi plane: the exact signed sum
                reduced.append((name, a, v.dtype, list(cumsum_u64_pair(
                    v, torch.where(v < 0, -1, 0).to(torch.int32)))))
            elif a == "sum":
                reduced.append((name, a, v.dtype,
                                list(cumsum_u64_pair(plane(v)))))
            else:
                reduced.append((name, a, v.dtype,
                                [segmented_reduce(v, is_new, a)]))

    if max_groups is not None:
        assert max_groups >= 1
        num_groups, overflow, posc, valid_g, pos_end = _extract(is_end,
                                                                max_groups)
        klo = torch.where(valid_g, slo[posc], -1)
        khi = torch.where(valid_g, shi[posc], -1)
        prev_pos = _shift_right_one(pos_end, 0)
        out = {}
        for name, a, dt, ps in reduced:
            if a == "count":
                out[name] = torch.where(valid_g, pos_end - prev_pos, 0)
            elif a == "sum" and dt != torch.float32:
                s = _diff_u64(torch.where(valid_g, ps[0][posc], 0),
                              torch.where(valid_g, ps[1][posc], 0))
                out[name] = U64(torch.where(valid_g, s.lo, 0),
                                torch.where(valid_g, s.hi, 0))
            elif a == "sum":
                ce = torch.where(valid_g, ps[0][posc], 0.0)
                out[name] = torch.where(
                    valid_g, ce - _shift_right_one(ce, 0.0), 0.0)
            else:
                out[name] = _fill(take_column(ps[0], posc), valid_g, 0)
        return MultiGroupResult(U64(klo, khi), out, num_groups, overflow)

    order = stable_partition(is_end)
    pos_end = order + 1
    prev_pos = _shift_right_one(pos_end, 0)
    num_groups = is_end.sum(dtype=torch.int64)
    out = {}
    for name, a, dt, ps in reduced:
        if a == "count":
            out[name] = pos_end - prev_pos
        elif a == "sum" and dt != torch.float32:
            out[name] = _diff_u64(ps[0][order], ps[1][order])
        elif a == "sum":
            rv = ps[0][order]
            out[name] = rv - _shift_right_one(rv, 0.0)
        else:
            out[name] = take_column(ps[0], order)
    return MultiGroupResult(U64(slo[order], shi[order]), out, num_groups)
