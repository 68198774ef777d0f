"""Exact quantiles (SQL PERCENTILE_DISC / PERCENTILE_CONT), global and per
group: the port of tpu_qe/ops/quantile.py.

PERCENTILE_DISC(q): the element at rank ceil(q*n) - 1 (0-based; q = 0 ->
rank 0), always an element of the data, so it is defined for u64 keys.
PERCENTILE_CONT(q): linear interpolation at row number q*(n-1). With
q = num/2^shift, num*(n-1) is an exact integer whose high bits are the
floor rank and whose low `shift` bits the exact fractional numerator, so
the *_cont operators return (lower, upper, frac_num, shift), the exact
rational answer, plus the float32 interpolation for 32-bit columns (U64
columns get the exact fields only).

Global quantiles are one sort and a gather at host-computed ranks.
Per-group quantiles sort (key, value bits) once (``sort_planes``: the
radix kernels on the card), find the group ends and gather each group's
rank positions. The per-group rank arithmetic ceil(num * cnt / 2^shift)
runs exactly through the widening multiply (bits.mul_u32_wide): float
rank math would mis-rank groups past 2^24 rows.

q values are snapped to the num / 2^QBITS grid (QBITS = 20); a
(num, shift) pair gives exact dyadic control up to 2^31.

Conventions of the port (as in ops/aggregate.py): counts, frac numerators,
num_groups and overflow are int64 tensors (num_groups and overflow 0-d);
values keep the column's dtype; U64 columns give U64 results.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_qe_torch.bits import (U64, U32_MASK, mul_u32_wide, narrow,
                               sortable_u32, sortable_u32_inverse, widen)
from tpu_qe_torch.ops.aggregate import _ends, _extract, _shift_right_one
from tpu_qe_torch.ops.filter import stable_partition
from tpu_qe_torch.sort.planes import sort_planes

QBITS = 20


def canon_qs(qs) -> tuple[tuple[int, int], ...]:
    """Normalize quantile specs to (num, shift) pairs meaning num/2^shift.

    Items are floats in [0, 1] (snapped to the 2^-QBITS grid) or
    (num, shift) integer pairs (exact dyadic rationals)."""
    out = []
    for q in ([qs] if isinstance(qs, (int, float)) else list(qs)):
        if isinstance(q, tuple):
            num, shift = q
            if not (isinstance(num, int) and isinstance(shift, int)
                    and 0 <= shift <= 31 and 0 <= num <= (1 << shift)):
                raise ValueError(f"bad (num, shift) quantile {q!r}")
            out.append((num, shift))
        else:
            if not 0.0 <= q <= 1.0:
                raise ValueError(f"quantile {q!r} outside [0, 1]")
            out.append((round(q * (1 << QBITS)), QBITS))
    if not out:
        raise ValueError("need at least one quantile")
    return tuple(out)


def disc_rank(num: int, shift: int, n: int) -> int:
    """Host-side exact PERCENTILE_DISC rank: ceil(num * n / 2^shift) - 1,
    clamped to [0, n-1]."""
    r = -((-num * n) >> shift) - 1  # ceil via negated floor (exact ints)
    return min(max(r, 0), n - 1)


def cont_rank(num: int, shift: int, n: int) -> tuple[int, int, int]:
    """Host-side exact PERCENTILE_CONT rank split: (floor_rank, ceil_rank,
    frac_num) with the interpolation point at num*(n-1)/2^shift."""
    prod = num * (n - 1)
    f = prod >> shift
    frac = prod & ((1 << shift) - 1)
    c = min(f + (1 if frac else 0), n - 1)
    return f, c, frac


def _disc_rank_device(num: int, shift: int, cnt: torch.Tensor):
    """Exact per-group rank ceil(num * cnt / 2^shift) - 1 clamped to
    [0, cnt-1], in the reference's u32 steps: cnt is an int64 tensor of
    u32 counts (padded garbage is taken mod 2^32, as in JAX), the result
    int64 in [0, 2^32)."""
    c = cnt & U32_MASK
    lo, hi = (widen(p) for p in mul_u32_wide(narrow(c), num))
    lo2 = (lo + ((1 << shift) - 1)) & U32_MASK
    hi2 = (hi + (lo2 < lo).to(torch.int64)) & U32_MASK
    r = lo2 if shift == 0 else (
        (lo2 >> shift) | (hi2 << (32 - shift))) & U32_MASK
    r = torch.clamp(r, min=1) - 1
    return torch.minimum(r, torch.clamp(c, min=1) - 1)


def _cont_rank_device(num: int, shift: int, cnt: torch.Tensor):
    """Exact per-group CONT rank split (floor, ceil, frac numerator) of
    num*(cnt-1)/2^shift, int64 tensors of u32 values; cnt as in
    _disc_rank_device."""
    cnt1 = torch.clamp(cnt & U32_MASK, min=1) - 1
    lo, hi = (widen(p) for p in mul_u32_wide(narrow(cnt1), num))
    if shift == 0:
        f, frac = lo, torch.zeros_like(lo)
    else:
        f = ((lo >> shift) | (hi << (32 - shift))) & U32_MASK
        frac = lo & ((1 << shift) - 1)
    f = torch.minimum(f, cnt1)
    c = torch.minimum(f + (frac != 0).to(torch.int64), cnt1)
    return f, c, frac


def _sorted_pick(col, ranks, backend):
    """The column sorted and read at `ranks`: U64 or a value-bit plane."""
    idx = torch.tensor(ranks, dtype=torch.int64,
                       device=(col.lo if isinstance(col, U64)
                               else col).device)
    if isinstance(col, U64):
        hi, lo = sort_planes([col.hi, col.lo], 2, backend=backend)
        return U64(lo[idx], hi[idx])
    (b,) = sort_planes([sortable_u32(col)], 1, backend=backend)
    return sortable_u32_inverse(b[idx], col.dtype)


def _length(col) -> int:
    return col.lo.shape[0] if isinstance(col, U64) else col.shape[0]


def quantile(col, qs, backend: str = "radix"):
    """Exact global PERCENTILE_DISC over a column.

    col: U64 or a uint32/int32/float32 tensor. qs: see canon_qs.
    Returns values with col's type, one per q (U64 -> U64 of len(qs))."""
    spec = canon_qs(qs)
    n = _length(col)
    assert n > 0, "quantile of an empty column"
    return _sorted_pick(col, [disc_rank(num, sh, n) for num, sh in spec],
                        backend)


def median(col, backend: str = "radix"):
    """Exact PERCENTILE_DISC(0.5) (the lower median element)."""
    return quantile(col, [(1, 1)], backend=backend)


class GroupQuantileResult(NamedTuple):
    """Padded per-group quantiles: the first num_groups rows are valid."""

    key: U64                  # unique group keys, ascending
    quantiles: torch.Tensor   # (len(qs), n_padded) in value dtype
    count: torch.Tensor       # (n_padded,) int64 rows per group
    num_groups: torch.Tensor  # 0-d int64, exact
    overflow: torch.Tensor | None = None  # 0-d int64, only with max_groups


def _group_layout(key: U64, value: torch.Tensor, max_groups, backend):
    """One (key, value bits) sort and the group layout: (sorted value bits,
    group keys, start, count, num_groups, overflow, valid_g).

    Without max_groups the group ends move to the front with a stable
    partition (the order of the reference's packed compaction sort) and
    the per-group planes are n long. With it, group ends come from a binary
    search over the end count, the planes are max_groups long, and padded
    entries carry all-ones keys and garbage counts (mask with valid_g)."""
    n = key.lo.shape[0]
    assert n > 0, "group quantile of an empty stream"
    assert n < (1 << 31), n
    shi, slo, sv = sort_planes([key.hi, key.lo, sortable_u32(value)], 3,
                               backend=backend)
    idx = torch.arange(n, device=slo.device)
    is_new = ((idx == 0) | (slo != _shift_right_one(slo, 0))
              | (shi != _shift_right_one(shi, 0)))
    is_end = _ends(is_new)
    if max_groups is None:
        order = stable_partition(is_end)
        pos_end = order + 1
        gkey = U64(slo[order], shi[order])
        num_groups, overflow, valid_g = is_end.sum(dtype=torch.int64), \
            None, None
    else:
        assert max_groups >= 1
        num_groups, overflow, posc, valid_g, pos_end = _extract(is_end,
                                                                max_groups)
        gkey = U64(torch.where(valid_g, slo[posc], -1),
                   torch.where(valid_g, shi[posc], -1))
    # groups are consecutive in the sorted stream: group g starts where g-1
    # ended
    start = _shift_right_one(pos_end, 0)
    return sv, gkey, start, pos_end - start, num_groups, overflow, valid_g


def _take_bits(sv, start, r, n, valid_g):
    """Value bits at start + r (clamped into bounds: padded entries read
    garbage), zero where valid_g is False."""
    v = sv[torch.clamp((start + r) & U32_MASK, max=n - 1)]
    return v if valid_g is None else torch.where(valid_g, v, 0)


def group_quantile(key: U64, value: torch.Tensor, qs,
                   max_groups: int | None = None,
                   backend: str = "radix") -> GroupQuantileResult:
    """Exact per-group PERCENTILE_DISC: GROUP BY key, PERCENTILE_DISC(q)
    WITHIN GROUP (ORDER BY value) for each q.

    max_groups: when the caller can bound the group count, outputs pad to
    max_groups and the rank gathers shrink from n to max_groups entries;
    num_groups stays exact and overflow is 1 past the bound (outputs
    truncated, never silently wrong)."""
    spec = canon_qs(qs)
    n = key.lo.shape[0]
    sv, gkey, start, cnt, num_groups, overflow, valid_g = _group_layout(
        key, value, max_groups, backend)
    planes = [_take_bits(sv, start, _disc_rank_device(num, sh, cnt), n,
                         valid_g) for num, sh in spec]
    if valid_g is not None:
        cnt = torch.where(valid_g, cnt, 0)
    return GroupQuantileResult(
        gkey, sortable_u32_inverse(torch.stack(planes), value.dtype), cnt,
        num_groups, overflow)


# --------------------------------------------------------------------------
# PERCENTILE_CONT: interpolation between the floor/ceil rank elements
# --------------------------------------------------------------------------

class ContQuantileResult(NamedTuple):
    """Exact rational PERCENTILE_CONT: the SQL answer is
    lower + (upper - lower) * frac_num/2^shift per q. `value` is the
    float32 interpolation (None for U64 columns)."""

    lower: object             # U64 or (Q,) tensor in col dtype
    upper: object
    frac_num: tuple           # per-q exact fractional numerators (host ints)
    shifts: tuple             # per-q denominators as 2^shift exponents
    value: torch.Tensor | None  # (Q,) float32, 32-bit columns only


def _to_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 of a u32 / i32 / f32 column, rounded to nearest."""
    if x.dtype == torch.uint32:
        return widen(x.view(torch.int32)).to(torch.float32)
    return x.to(torch.float32)


def quantile_cont(col, qs, backend: str = "radix") -> ContQuantileResult:
    """Exact global PERCENTILE_CONT over a column (module docstring)."""
    spec = canon_qs(qs)
    n = _length(col)
    assert n > 0, "quantile_cont of an empty column"
    trip = [cont_rank(num, sh, n) for num, sh in spec]
    ranks = [r for f, c, _ in trip for r in (f, c)]
    fracs = tuple(fr for _, _, fr in trip)
    shifts = tuple(sh for _, sh in spec)
    b = _sorted_pick(col, ranks, backend)
    if isinstance(col, U64):
        return ContQuantileResult(U64(b.lo[0::2], b.hi[0::2]),
                                  U64(b.lo[1::2], b.hi[1::2]),
                                  fracs, shifts, None)
    lower, upper = b[0::2], b[1::2]
    return ContQuantileResult(lower, upper, fracs, shifts, _interp_f32(
        lower, upper, [fr / (1 << sh) for fr, sh in zip(fracs, shifts)]))


def _interp_f32(lower: torch.Tensor, upper: torch.Tensor,
                fracs) -> torch.Tensor:
    """float32 interpolation lower + (upper - lower) * fracs of (Q,)
    columns at host fractions."""
    lo_f = _to_f32(lower)
    w = torch.tensor(fracs, dtype=torch.float32, device=lo_f.device)
    return lo_f + (_to_f32(upper) - lo_f) * w


class GroupContQuantileResult(NamedTuple):
    """Padded per-group PERCENTILE_CONT: the first num_groups rows are
    valid. Exact answer per (q, group): lower + (upper-lower)*frac/2^shift."""

    key: U64
    lower: torch.Tensor       # (Q, n_padded) in value dtype
    upper: torch.Tensor
    frac: torch.Tensor        # (Q, n_padded) int64 exact numerators
    shifts: tuple             # per-q 2^shift exponents
    value: torch.Tensor       # (Q, n_padded) float32 interpolation
    count: torch.Tensor
    num_groups: torch.Tensor
    overflow: torch.Tensor | None = None  # 0-d int64, only with max_groups


def group_quantile_cont(key: U64, value: torch.Tensor, qs,
                        max_groups: int | None = None,
                        backend: str = "radix") -> GroupContQuantileResult:
    """Exact per-group PERCENTILE_CONT: GROUP BY key, PERCENTILE_CONT(q)
    WITHIN GROUP (ORDER BY value) for each q: the group_quantile layout
    with two rank gathers per q and the exact fractional numerator.
    max_groups: see group_quantile."""
    spec = canon_qs(qs)
    n = key.lo.shape[0]
    sv, gkey, start, cnt, num_groups, overflow, valid_g = _group_layout(
        key, value, max_groups, backend)
    lows, ups, fracs, vals = [], [], [], []
    for num, sh in spec:
        f, c, frac = _cont_rank_device(num, sh, cnt)
        lower = sortable_u32_inverse(_take_bits(sv, start, f, n, valid_g),
                                     value.dtype)
        upper = sortable_u32_inverse(_take_bits(sv, start, c, n, valid_g),
                                     value.dtype)
        if valid_g is not None:
            frac = torch.where(valid_g, frac, 0)
        lo_f = _to_f32(lower)
        frac_f = frac.to(torch.float32) * (1.0 / (1 << sh))
        lows.append(lower)
        ups.append(upper)
        fracs.append(frac)
        vals.append(lo_f + (_to_f32(upper) - lo_f) * frac_f)
    if valid_g is not None:
        cnt = torch.where(valid_g, cnt, 0)
    return GroupContQuantileResult(
        gkey, _stack(lows), _stack(ups), torch.stack(fracs),
        tuple(sh for _, sh in spec), torch.stack(vals), cnt, num_groups,
        overflow)


def _stack(cols: list) -> torch.Tensor:
    """torch.stack of u32 / i32 / f32 columns of one dtype."""
    if cols[0].dtype == torch.uint32:
        return torch.stack([c.view(torch.int32) for c in cols]).view(
            torch.uint32)
    return torch.stack(cols)
