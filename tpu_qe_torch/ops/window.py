"""SQL window functions, OVER (PARTITION BY key [ORDER BY order]): the port
of tpu_qe/ops/window.py.

One stable sort by (partition key, order) puts every partition contiguous
and in order (``sort_planes``: the radix kernels on the card; the
stability gives SQL's tie break by input position, which the JAX package
buys with a position key). Every function is then a sweep over the sorted
stream:

- row_number / rank / dense_rank / percent_rank / ntile: index arithmetic
  on the partition and order-run starts (blocked running max,
  ops/segscan.py) and ends;
- running / moving / total / RANGE sums: exact for integer columns (the
  u64 sum of uint32 values, the two's-complement signed sum of int32
  values, returned as U64 (lo, hi) planes: the int64 running sum of the
  widened values, exact since n < 2^31 rows of 32-bit values cannot leave
  int64), float32 per-partition scans in the JAX package's blocked order
  for float columns (aggregate.segmented_reduce), so float results come
  out with the reference's rounding;
- min / max frames: segmented scans, log-doubling shifts (moving frames)
  or a sparse table (bounded RANGE);
- lag / lead / first_value / last_value and the whole-partition and
  RANGE broadcasts: shifts and gathers at the partition and run bounds.

Where the JAX package sorts instead of searching or scattering (the
bounded RANGE frames' union sort, the input-order restore sort), the port
uses ``torch.searchsorted``, gathers and an inverse-permutation scatter:
the outputs are the same.

The order column's sort plane is ``bits.sortable_u32(order)``, compared
unsigned, for every order dtype. The JAX package sorts int32 orders as
signed values but decodes that plane as if it were sign-flipped when it
builds a bounded RANGE frame's lower bound, so over int32 orders that
span zero its bounded RANGE frames differ from SQL; the port's follow SQL
(tests/test_torch_window.py pins both).

Conventions of the port: u32 outputs (row_number, rank, counts) are
torch.uint32 columns; value outputs keep the value column's dtype; float
averages and percent_rank are float32; integer sums are U64; positions
(WindowResult.pos) are int64.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from tpu_qe_torch.bits import U64, U32_MASK, narrow, sortable_u32, \
    sortable_u32_inverse, widen
from tpu_qe_torch.ops.aggregate import _ends, _shift_right_one, \
    segmented_reduce
from tpu_qe_torch.ops.segscan import cummax_int64
from tpu_qe_torch.sort.planes import argsort_planes
from tpu_qe_torch.table import from_plane, plane, take_column

_RUNNING = ("running_sum", "running_min", "running_max")
# whole-partition functions: they read the partition's full extent
_WHOLE = ("first_value", "last_value", "ntile", "percent_rank")
# moving frames: ROWS BETWEEN k-1 PRECEDING AND CURRENT ROW [.. b FOLLOWING]
_MOVING = ("moving_sum", "moving_min", "moving_max", "moving_avg")
# whole-partition aggregate frames (agg OVER (PARTITION BY k)), and the
# running average
_TOTAL = ("total_sum", "total_min", "total_max", "total_avg",
          "partition_count", "running_avg")
_RANGE = ("range_sum", "range_min", "range_max", "range_avg")
_VALID_FUNCS = (("row_number", "rank", "dense_rank", "lag", "lead",
                 "moving_count")
                + _RUNNING + _WHOLE + _MOVING + _TOTAL + _RANGE)
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


class WindowResult(NamedTuple):
    """Per-row window outputs.

    cols: out_name -> (n,) column; integer sums are U64 (lo, hi) pairs.
    With output="input" rows align with the input; with output="sorted"
    rows are in (partition, order, position) order and `pos` (int64) gives
    each row's input position (None for "input").
    """

    cols: dict
    pos: torch.Tensor | None = None


def _canon_funcs(funcs: dict) -> tuple:
    """dict -> hashable, validated (name, kind, col, fill) tuple spec."""
    spec = []
    for name in sorted(funcs):
        f = funcs[name]
        if isinstance(f, str):
            f = (f,)
        kind = f[0]
        if kind not in _VALID_FUNCS:
            raise ValueError(f"unknown window function {kind!r}")
        col = f[1] if len(f) > 1 else None
        fill = f[2] if len(f) > 2 else 0
        if kind in _RUNNING + _MOVING + _RANGE + (
                "lag", "lead", "first_value", "last_value", "total_sum",
                "total_min", "total_max", "total_avg", "running_avg") \
                and col is None:
            raise ValueError(f"{kind} needs a value column")
        if kind in _RANGE:
            # (kind, col, bound): the order-value window; "unbounded" is
            # SQL's default RANGE UNBOUNDED PRECEDING .. CURRENT ROW
            if fill != "unbounded" and not (
                    isinstance(fill, (int, float))
                    and not isinstance(fill, bool) and fill >= 0):
                raise ValueError(f"{kind} bound must be a non-negative "
                                 f"number or 'unbounded', got {fill!r}")
        if kind in _MOVING:
            # (kind, col, k[, b]): backward width k incl. the current row
            # (None = UNBOUNDED PRECEDING), optional b rows FOLLOWING packed
            # with k into a (k, b) pair
            b_f = f[3] if len(f) > 3 else 0
            if not (isinstance(b_f, int) and b_f >= 0):
                raise ValueError(f"{kind} FOLLOWING bound must be an "
                                 f"int >= 0, got {b_f!r}")
            if fill is None:
                if b_f < 1:
                    raise ValueError(
                        f"{kind} with UNBOUNDED PRECEDING needs a "
                        "FOLLOWING bound (use the running frame "
                        "otherwise)")
            elif not (isinstance(fill, int) and fill >= 1):
                raise ValueError(f"{kind} needs a static frame width "
                                 f">= 1, got {fill!r}")
            if b_f:
                fill = (fill, b_f)
        if kind in ("lag", "lead"):
            # (kind, col[, fill[, offset]]): an offset k != 1 rides the
            # fill slot as a (fill, k) pair
            off = f[3] if len(f) > 3 else 1
            if not (isinstance(off, int) and off >= 1):
                raise ValueError(f"{kind} offset must be an int >= 1, "
                                 f"got {off!r}")
            if off != 1:
                fill = (fill, off)
        if kind == "ntile":
            # ("ntile", k): k rides the col slot, the static bucket count
            if not (isinstance(col, int) and col >= 1):
                raise ValueError(f"ntile needs a bucket count >= 1, "
                                 f"got {col!r}")
            spec.append((name, kind, None, col))
            continue
        if kind == "moving_count":
            # ("moving_count", k[, b]): k rides the col slot (None =
            # UNBOUNDED PRECEDING), optional b rows FOLLOWING
            kk, bb = col, fill if fill else 0
            if kk is not None and not (isinstance(kk, int) and kk >= 1):
                raise ValueError(f"moving_count needs a frame width "
                                 f">= 1 or None, got {kk!r}")
            if not (isinstance(bb, int) and bb >= 0):
                raise ValueError(f"moving_count FOLLOWING bound must "
                                 f"be an int >= 0, got {bb!r}")
            spec.append((name, kind, None, (kk, bb)))
            continue
        spec.append((name, kind, col, fill))
    return tuple(spec)


# ------------------------------------------------------------------ helpers

def _u32(x: torch.Tensor) -> torch.Tensor:
    """A u32 output column from int64 values in [0, 2^32)."""
    return from_plane(narrow(x), torch.uint32)


def _shift_k(p: torch.Tensor, k: int, fill) -> torch.Tensor:
    """Shift right by k rows, `fill` in front."""
    if k == 0:
        return p
    if k >= p.shape[0]:
        return torch.full_like(p, fill)
    return torch.cat([torch.full((k,), fill, dtype=p.dtype,
                                 device=p.device), p[:-k]])


def _fill_plane(value, dtype: torch.dtype):
    """The int32 bit pattern of scalar `value` in a u32 / i32 / f32
    column."""
    if dtype == torch.float32:
        return int(torch.tensor(float(value), dtype=torch.float32).view(
            torch.int32))
    return int(narrow(torch.tensor(int(value), dtype=torch.int64)))


def _exact(v: torch.Tensor) -> torch.Tensor:
    """int64 values whose sums are the exact integer sums: uint32 columns
    zero-extend, int32 columns sign-extend (the JAX package's i64-in-U64
    pair)."""
    return widen(plane(v)) if v.dtype == torch.uint32 else v.to(torch.int64)


def _pair(s: torch.Tensor) -> U64:
    """The U64 (lo, hi) planes of int64 sums, mod 2^64."""
    return U64(narrow(s), narrow(s >> 32))


def _pair_to_f32(s: torch.Tensor, signed: bool) -> torch.Tensor:
    """float32 of an exact sum as the JAX package computes it from the
    pair: lo + hi * 2^32 in float32, of the magnitude when signed."""
    mag = s.abs() if signed else s
    f = ((mag & U32_MASK).to(torch.float32)
         + (mag >> 32).to(torch.float32) * 4294967296.0)
    return torch.where(s < 0, -f, f) if signed else f


def _order32(v: torch.Tensor) -> torch.Tensor:
    """An int32 / float32 tensor whose order is v's (u32 sign-flipped) for
    min / max work; _from_order32 undoes it."""
    if v.dtype == torch.uint32:
        return plane(v) ^ _INT32_MIN
    return v


def _from_order32(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.uint32:
        return from_plane(x ^ _INT32_MIN, dtype)
    return x


def _neutral(agg: str, dtype: torch.dtype):
    """Neutral element of min / max in _order32's representation."""
    if dtype == torch.float32:
        return float("inf") if agg == "min" else float("-inf")
    return _INT32_MAX if agg == "min" else _INT32_MIN


def _minmax_op(agg: str):
    return torch.minimum if agg == "min" else torch.maximum


class _Extent:
    """Partition and order-run bounds of the sorted stream, made when a
    function first needs them (int64 row indices)."""

    def __init__(self, idx, is_new, order_new, is_last):
        self.idx, self.is_new, self.order_new = idx, is_new, order_new
        self.is_last = is_last

    def _last(self, flags):
        """Index of the last row of the run each row lies in (flags mark
        run ends): the run-start fill of the reversed stream."""
        rev = cummax_int64(torch.where(torch.flip(flags, [0]), self.idx, 0))
        return self.idx.shape[0] - 1 - torch.flip(rev, [0])

    @functools.cached_property
    def part_start(self):
        return cummax_int64(torch.where(self.is_new, self.idx, 0))

    @functools.cached_property
    def run_start(self):
        return cummax_int64(torch.where(self.order_new, self.idx, 0))

    @functools.cached_property
    def part_end(self):
        return self._last(self.is_last)

    @functools.cached_property
    def run_end(self):
        # SQL RANGE frames end at the current row's last order peer
        return self._last(_ends(self.order_new))

    @property
    def rn0(self):
        return self.idx - self.part_start

    def running_exact(self, v):
        return _running_exact(v, self.part_start)


def _running_exact(v, part_start):
    """Per-partition inclusive int64 running sum of _exact(v): the global
    prefix sum less the prefix before each row's partition start."""
    x = _exact(v)
    p = torch.cumsum(x, 0)
    return p - (p[part_start] - x[part_start])


def _window_sorted_cols(spec, scols, idx, is_new, order_new, is_last,
                        need_aux: bool = False, sorder=None, odt=None):
    """All window columns over an already partition-sorted stream.

    spec: _canon_funcs output; scols: value columns in stream order; idx:
    int64 row indices 0..n-1; is_new / order_new / is_last: bool flags of
    partition starts, (partition, order)-run starts and partition ends;
    sorder: the order column's sortable_u32 plane (bounded RANGE frames
    need it) and odt its dtype.

    Returns (out, aux): aux holds the partition / run start and partition
    end index planes (int64) when need_aux or when a function made them.
    """
    ext = _Extent(idx, is_new, order_new, is_last)
    if need_aux:
        for bound in ("part_start", "run_start"):
            getattr(ext, bound)
    out: dict = {}
    for name, kind, col, fill in spec:
        v = scols.get(col) if isinstance(col, str) else None
        if kind == "row_number":
            out[name] = _u32(ext.rn0 + 1)
        elif kind == "rank":
            out[name] = _u32(ext.run_start - ext.part_start + 1)
        elif kind == "dense_rank":
            # running count of order-run starts, rebased to the count just
            # before the partition's first run (non-decreasing: cummax)
            c = torch.cumsum(order_new.to(torch.int64), 0)
            base = cummax_int64(torch.where(is_new, c - 1, 0))
            out[name] = _u32(c - base)
        elif kind == "running_sum":
            out[name] = (segmented_reduce(v, is_new, "sum")
                         if v.dtype == torch.float32
                         else _pair(ext.running_exact(v)))
        elif kind in ("running_min", "running_max"):
            out[name] = segmented_reduce(v, is_new, kind[-3:])
        elif kind in _TOTAL:
            out[name] = _total(kind, v, ext)
        elif kind in _MOVING:
            if isinstance(fill, tuple):     # (k, b) FOLLOWING frame
                kk, bb = fill
                out[name] = _moving_follow(kind, v, kk, bb, ext)
            else:
                out[name] = _moving(kind, v, fill, is_new, ext.rn0, ext)
        elif kind in ("lag", "lead"):
            f_, k_ = fill if isinstance(fill, tuple) else (fill, 1)
            p, fp = plane(v), _fill_plane(f_, v.dtype)
            if kind == "lag":
                got = _shift_k(p, k_, fp)
                keep = ~is_new if k_ == 1 else ext.rn0 >= k_
            else:
                got = torch.cat([p[k_:], torch.full(
                    (min(k_, p.shape[0]),), fp, dtype=p.dtype,
                    device=p.device)])
                keep = ~is_last if k_ == 1 else idx + k_ <= ext.part_end
            out[name] = from_plane(torch.where(keep, got, fp), v.dtype)
        elif kind in _RANGE:
            out[name] = _range(kind, v, fill, ext, sorder, odt)
        elif kind == "first_value":
            out[name] = take_column(v, ext.part_start)
        elif kind == "last_value":
            # whole-partition frame (the useful SQL variant)
            out[name] = take_column(v, ext.part_end)
        elif kind == "moving_count":
            # frame row count, clamped at both partition edges
            kk, bb = fill
            back = ext.rn0 + 1 if kk is None else torch.clamp(ext.rn0 + 1,
                                                             max=kk)
            out[name] = _u32(back + torch.clamp(ext.part_end - idx, max=bb))
        elif kind == "ntile":
            cnt = ext.part_end - ext.part_start + 1
            q, r = cnt // fill, cnt % fill
            rn0 = ext.rn0
            big = r * (q + 1)
            hi_b = r + (rn0 - big) // torch.clamp(q, min=1)
            out[name] = _u32(torch.where(rn0 < big, rn0 // (q + 1), hi_b)
                             + 1)
        elif kind == "percent_rank":
            cnt = ext.part_end - ext.part_start + 1
            rank0 = (ext.run_start - ext.part_start).to(torch.float32)
            out[name] = rank0 / torch.clamp(cnt - 1, min=1).to(torch.float32)
    return out, {k: vars(ext).get(k)
                 for k in ("part_start", "run_start", "part_end")}


def _total(kind: str, v, ext: _Extent):
    """Whole-partition aggregates (the running value at the partition end,
    broadcast over the partition), partition_count and running_avg."""
    if kind == "partition_count":
        return _u32(ext.part_end - ext.part_start + 1)
    if kind in ("total_min", "total_max"):
        return take_column(segmented_reduce(v, ext.is_new, kind[-3:]),
                           ext.part_end)
    running = kind == "running_avg"
    if v.dtype == torch.float32:
        num = segmented_reduce(v, ext.is_new, "sum")
        num = num if running else num[ext.part_end]
        if kind == "total_sum":
            return num
    else:
        s = ext.running_exact(v)
        s = s if running else s[ext.part_end]
        if kind == "total_sum":
            return _pair(s)
        num = _pair_to_f32(s, v.dtype == torch.int32)
    den = ext.rn0 + 1 if running else ext.part_end - ext.part_start + 1
    return num / den.to(torch.float32)


def _moving(kind: str, v, k: int, is_new, rn0, ext: _Extent):
    """ROWS BETWEEN k-1 PRECEDING AND CURRENT ROW, clamped to the
    partition (rn0 = row offset within its partition).

    moving_sum: the per-partition running sum minus its own value k rows
    back (zero while rn0 < k): exact U64 for integer columns, float32
    difference of the blocked per-partition scan for float columns.
    moving_min / max: log-doubling partition-masked shifts up to the
    largest power of two P <= k, then two overlapping width-P windows.
    moving_avg: the sum over min(rn0 + 1, k) as float32.
    """
    if kind in ("moving_sum", "moving_avg"):
        if v.dtype == torch.float32:
            s = segmented_reduce(v, is_new, "sum")
            ms = s - torch.where(rn0 >= k, _shift_k(s, k, 0.0), 0.0)
            if kind == "moving_sum":
                return ms
        else:
            s = ext.running_exact(v)
            m = s - torch.where(rn0 >= k, _shift_k(s, k, 0), 0)
            if kind == "moving_sum":
                return _pair(m)
            ms = _pair_to_f32(m, v.dtype == torch.int32)
        return ms / torch.clamp(rn0 + 1, max=k).to(torch.float32)
    agg = kind[-3:]
    op, neutral = _minmax_op(agg), _neutral(agg, v.dtype)
    m = _order32(v)
    if k > 1:
        p = 1 << (k.bit_length() - 1)   # largest power of two <= k
        s = 1
        while s < p:
            m = op(m, torch.where(rn0 >= s, _shift_k(m, s, neutral),
                                  neutral))
            s <<= 1
        if k > p:
            m = op(m, torch.where(rn0 >= k - p, _shift_k(m, k - p, neutral),
                                  neutral))
    return _from_order32(m, v.dtype)


class _Reversed:
    """The reversed stream's view of an _Extent, for forward frames: its
    partition starts are the partition ends, its row offsets part_end -
    idx."""

    def __init__(self, ext: _Extent):
        self.ext = ext
        self.is_new = torch.flip(ext.is_last, [0])
        self.rn0 = torch.flip(ext.part_end - ext.idx, [0])
        self.part_start = ext.idx - self.rn0

    def running_exact(self, v):
        return _running_exact(v, self.part_start)


def _moving_follow(kind: str, v, k, b: int, ext: _Extent):
    """ROWS BETWEEN k-1 PRECEDING AND b FOLLOWING (k None = UNBOUNDED
    PRECEDING), clamped to the partition: the backward frame at row i
    combined with the backward frame of width b+1 of the reversed stream;
    sums count row i twice and subtract it once, min / max absorb it."""
    rev = _Reversed(ext)
    rv = from_plane(torch.flip(plane(v), [0]), v.dtype)
    if kind in ("moving_sum", "moving_avg"):
        if v.dtype == torch.float32:
            back = (segmented_reduce(v, ext.is_new, "sum") if k is None
                    else _moving("moving_sum", v, k, ext.is_new, ext.rn0,
                                 ext))
            fwd = _moving("moving_sum", rv, b + 1, rev.is_new, rev.rn0, rev)
            ms = back + torch.flip(fwd, [0]) - v
            if kind == "moving_sum":
                return ms
        else:
            s = ext.running_exact(v)
            back = s if k is None else s - torch.where(
                ext.rn0 >= k, _shift_k(s, k, 0), 0)
            rs = rev.running_exact(rv)
            fwd = rs - torch.where(rev.rn0 >= b + 1,
                                   _shift_k(rs, b + 1, 0), 0)
            m = back + torch.flip(fwd, [0]) - _exact(v)
            if kind == "moving_sum":
                return _pair(m)
            ms = _pair_to_f32(m, v.dtype == torch.int32)
        kb = ext.rn0 + 1 if k is None else torch.clamp(ext.rn0 + 1, max=k)
        cnt = kb + torch.clamp(ext.part_end - ext.idx, max=b)
        return ms / cnt.to(torch.float32)
    agg = kind[-3:]
    back = (segmented_reduce(v, ext.is_new, agg) if k is None
            else _moving(kind, v, k, ext.is_new, ext.rn0, ext))
    fwd = _order32(_moving(kind, rv, b + 1, rev.is_new, rev.rn0, rev))
    return _from_order32(_minmax_op(agg)(_order32(back),
                                         torch.flip(fwd, [0])), v.dtype)


def _range(kind: str, v, bound, ext: _Extent, sorder, odt):
    """RANGE frames: "unbounded" (UNBOUNDED PRECEDING .. the current row's
    last peer: the running value at the run end) or a numeric bound x
    (order values in [order_i - x, order_i], through the last peer)."""
    agg = kind.rsplit("_", 1)[1]
    if bound == "unbounded":
        at = ext.run_end
        if agg in ("min", "max"):
            return take_column(segmented_reduce(v, ext.is_new, agg), at)
        if v.dtype == torch.float32:
            tot = segmented_reduce(v, ext.is_new, "sum")[at]
            if agg == "sum":
                return tot
            num = tot
        else:
            s = ext.running_exact(v)[at]
            if agg == "sum":
                return _pair(s)
            num = _pair_to_f32(s, v.dtype == torch.int32)
        return num / (at - ext.part_start + 1).to(torch.float32)
    if sorder is None:
        raise ValueError("bounded RANGE frames need the order plane "
                         "(in-core window only)")
    cnt_lt = _rows_below(sorder, odt, bound, ext)
    if agg in ("min", "max"):
        return _range_minmax(agg, v, ext.part_start + cnt_lt, ext.run_end)
    below = torch.clamp(ext.part_start + cnt_lt - 1, min=0)
    if v.dtype == torch.float32:
        run = segmented_reduce(v, ext.is_new, "sum")
        fsum = run[ext.run_end] - torch.where(cnt_lt > 0, run[below], 0.0)
        num = fsum
    else:
        run = ext.running_exact(v)
        s = run[ext.run_end] - torch.where(cnt_lt > 0, run[below], 0)
        if agg == "sum":
            return _pair(s)
        num = _pair_to_f32(s, v.dtype == torch.int32)
    if agg == "sum":
        return fsum
    cnt = ext.run_end - ext.part_start + 1 - cnt_lt
    return num / torch.clamp(cnt, min=1).to(torch.float32)


def _rows_below(sorder, odt, x, ext: _Extent) -> torch.Tensor:
    """Per row, the rows of its partition whose order value lies below its
    frame's lower bound order_i - x (saturating in the order dtype: u32
    floors at 0, i32 at INT_MIN, f32 subtracts in float32): a binary search
    of (partition, order bits), which ascend along the stream."""
    ovals = sortable_u32_inverse(sorder, odt)
    if odt == torch.float32:
        q = sortable_u32(ovals - torch.tensor(float(x),
                                              dtype=torch.float32))
    elif odt == torch.int32:
        q = sortable_u32(torch.clamp(ovals.to(torch.int64) - int(x),
                                     min=_INT32_MIN).to(torch.int32))
    else:
        q = narrow(torch.clamp(widen(plane(ovals)) - int(x), min=0))
    part = (torch.cumsum(ext.is_new.to(torch.int64), 0) - 1) << 32
    pos = torch.searchsorted(part | widen(sorder), part | widen(q))
    return pos - ext.part_start


# bounded RANGE MIN/MAX builds a (levels x n) sparse table; larger calls
# raise with this cap in the message (the JAX package's limit)
_RANGE_MM_CAP = 1 << 25


def _range_minmax(agg: str, v, s_idx, t_idx):
    """min / max over stream rows [s_idx, t_idx] per row: a sparse table of
    L = log2(n) + 1 doubling levels (level j holds op over [p, p + 2^j)),
    read at level floor(log2(t - s + 1)) from both ends."""
    n = v.shape[0]
    if n > _RANGE_MM_CAP:
        raise ValueError(
            f"bounded RANGE {agg} supports up to {_RANGE_MM_CAP} rows "
            f"per call (got {n}): the interval-min sparse table is "
            "(log2(n)+1) x n values in device memory")
    op, neutral = _minmax_op(agg), _neutral(agg, v.dtype)
    cur = _order32(v)
    levels = [cur]
    for j in range(max(0, n.bit_length() - 1)):
        sh = 1 << j
        if sh >= n:
            break
        cur = op(cur, torch.cat([cur[sh:], torch.full(
            (sh,), neutral, dtype=cur.dtype, device=cur.device)]))
        levels.append(cur)
    table = torch.stack(levels)
    # floor(log2(cnt)), exact: cnt < 2^31 is exact in float64
    lvl = torch.frexp((t_idx - s_idx + 1).to(torch.float64)).exponent - 1
    lvl = lvl.to(torch.int64)
    r1 = table[lvl, s_idx]
    r2 = table[lvl, t_idx - (torch.ones_like(lvl) << lvl) + 1]
    return _from_order32(op(r1, r2), v.dtype)


def _empty(spec, values, output, device):
    z32 = torch.zeros(0, dtype=torch.int32, device=device)
    cols = {}
    for name, kind, col, _ in spec:
        if (kind in ("running_sum", "moving_sum", "total_sum", "range_sum")
                and values[col].dtype != torch.float32):
            cols[name] = U64(z32, z32)
        elif kind in _RUNNING + ("moving_sum", "moving_min", "moving_max",
                                 "lag", "lead", "first_value", "last_value",
                                 "total_sum", "total_min", "total_max",
                                 "range_sum", "range_min", "range_max"):
            cols[name] = from_plane(z32, values[col].dtype)
        elif kind in ("percent_rank", "moving_avg", "total_avg",
                      "running_avg", "range_avg"):
            cols[name] = torch.zeros(0, dtype=torch.float32, device=device)
        else:
            cols[name] = from_plane(z32, torch.uint32)
    pos = (torch.zeros(0, dtype=torch.int64, device=device)
           if output == "sorted" else None)
    return WindowResult(cols, pos)


def window(key: U64, funcs: dict, order: torch.Tensor | None = None,
           values: dict | None = None, output: str = "input",
           backend: str = "radix") -> WindowResult:
    """Window functions over PARTITION BY `key` [ORDER BY `order`].

    key: (n,) U64 partition keys. funcs: out_name -> spec, as in
    tpu_qe.ops.window.window: "row_number" / ("rank",) / ("dense_rank",) /
    ("percent_rank",) / ("running_sum"|"running_min"|"running_max", col) /
    ("lag"|"lead", col[, fill[, offset]]) / ("first_value"|"last_value",
    col) / ("ntile", k) / ("moving_sum"|"moving_min"|"moving_max"|
    "moving_avg", col, k[, b]) / ("moving_count", k[, b]) /
    ("total_sum"|"total_min"|"total_max"|"total_avg"|"running_avg", col) /
    ("partition_count",) / ("range_sum"|"range_min"|"range_max"|
    "range_avg", col, bound), bound a number >= 0 or "unbounded".
    Value columns come from `values` (uint32 / int32 / float32).
    order: optional ORDER BY column (uint32 / int32 / float32); ties and
    the no-order case resolve by input position. output: "input" (rows
    align with the input) or "sorted" (stream order; WindowResult.pos maps
    rows to input positions). backend: the sort's ("radix" or "torch").
    """
    spec = _canon_funcs(funcs)
    if output not in ("input", "sorted"):
        raise ValueError(f"unknown output mode {output!r}")
    if order is None and any(k in ("rank", "dense_rank", "percent_rank")
                             + _RANGE for _, k, _, _ in spec):
        raise ValueError("rank/dense_rank/percent_rank and RANGE "
                         "frames require an order column")
    values = values or {}
    needed = sorted({c for _, _, c, _ in spec if c is not None})
    for c in needed:
        if c not in values:
            raise ValueError(f"window spec references missing column {c!r}")
    n = key.lo.shape[0]
    if n == 0:
        return _empty(spec, values, output, key.lo.device)
    keys = [key.hi, key.lo]
    if order is not None:
        keys.append(sortable_u32(order))
    skeys, perm = argsort_planes(keys, backend=backend)
    perm = perm.to(torch.int64)
    shi, slo = skeys[0], skeys[1]
    sorder = skeys[2] if order is not None else None
    scols = {c: take_column(values[c], perm) for c in needed}
    idx = torch.arange(n, device=slo.device)
    is_new = ((idx == 0) | (slo != _shift_right_one(slo, 0))
              | (shi != _shift_right_one(shi, 0)))
    order_new = is_new if sorder is None else (
        is_new | (sorder != _shift_right_one(sorder, 0)))
    out, _ = _window_sorted_cols(
        spec, scols, idx, is_new, order_new, _ends(is_new), sorder=sorder,
        odt=None if order is None else order.dtype)
    if output == "sorted":
        return WindowResult(out, perm)
    inv = torch.empty_like(perm)
    inv[perm] = idx             # input row i sits at stream row inv[i]
    return WindowResult({nm: take_column(c, inv) for nm, c in out.items()})
