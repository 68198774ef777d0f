"""Joins on u64 keys over columnar tables: the port of tpu_qe/ops/join.py.

Sort + search formulations, as in the JAX package: the data sorts run
through ``sort_planes`` (the radix kernels on the card), probes are
``torch.searchsorted`` over an order-preserving int64 form of the key, and
the packed-position compaction sorts of the JAX package become stable
partitions or scatters that give the same rows.

Conventions of the port: positions, counts and indices are int64 tensors
(num_out, overflow 0-d); value columns keep their dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_qe_torch.bits import U64
from tpu_qe_torch.ops.filter import stable_partition
from tpu_qe_torch.ops.segscan import cummax_int64
from tpu_qe_torch.sort.driver import signed_key
from tpu_qe_torch.sort.planes import argsort_planes
from tpu_qe_torch.table import Column, Table, from_plane, plane, take_column
from tpu_qe_torch.utils.profiling import span


def searchsorted_u64(sorted_key: U64, query: U64, side: str = "left"):
    """Insertion positions (int64) of each query in a sorted u64 column."""
    return torch.searchsorted(signed_key(sorted_key.lo, sorted_key.hi),
                              signed_key(query.lo, query.hi), side=side)


def _mask(col: Column, m: torch.Tensor) -> Column:
    """col where m, else zero (the engine's NULL convention)."""
    if isinstance(col, U64):
        return U64(torch.where(m, col.lo, 0), torch.where(m, col.hi, 0))
    return from_plane(torch.where(m, plane(col), 0), col.dtype)


def _zero_column(col: Column, n: int, device) -> Column:
    z = torch.zeros(n, dtype=torch.int32, device=device)
    return U64(z, z) if isinstance(col, U64) else from_plane(z, col.dtype)


def _take(table: Table, idx: torch.Tensor) -> Table:
    """Row gather that reads zero rows from a table with no rows: every
    slot that gathers from an empty side is one the caller masks (an
    unmatched or padding slot), where torch's gather would raise."""
    if table.num_rows or not idx.numel():
        return table.take(idx)
    return Table({nm: _zero_column(table[nm], idx.shape[0], idx.device)
                  for nm in table})


def _merge(left_cols: Table, right_cols: Table, fn=None) -> dict:
    """Left columns, then right columns (renamed right_<name> on a clash)."""
    cols = {nm: left_cols[nm] for nm in left_cols}
    for nm in right_cols:
        c = right_cols[nm]
        cols[nm if nm not in cols else f"right_{nm}"] = c if fn is None \
            else fn(c)
    return cols


class FkJoinResult(NamedTuple):
    """Foreign-key join output: left rows + gathered right columns."""

    table: Table
    matched: torch.Tensor     # bool: the left row had a right match


def join_fk(left: Table, right: Table, key: str = "key",
            backend: str = "radix") -> FkJoinResult:
    """Equi-join where right[key] values are unique: sort the right table
    by key, probe with a binary search. Unmatched left rows get the
    gathered values of a clamped probe and matched=False; against an
    empty right table every row is unmatched, with right columns 0 (the
    JAX join_fk raises there, and its join_fk_scan gives these rows)."""
    if not isinstance(right[key], U64):
        raise TypeError("join key must be u64")
    right_sorted = right.sort_by(key, backend=backend)
    rkey, lkey = right_sorted[key], left[key]
    m = rkey.lo.shape[0]
    pos = searchsorted_u64(rkey, lkey)
    pos_c = torch.clamp(pos, max=max(m - 1, 0))
    matched = pos < m
    if m:
        matched = (matched & (rkey.lo[pos_c] == lkey.lo)
                   & (rkey.hi[pos_c] == lkey.hi))
    cols = _merge(left.drop(key), _take(right_sorted.drop(key), pos_c))
    cols[key] = lkey
    return FkJoinResult(Table(cols), matched)


class StreamJoinResult(NamedTuple):
    """join_fk_scan's key-ordered stream (output="stream"), n_l + n_r rows:
    key (sorted), lidx (the row's index on its own side), right value
    columns forward-filled (zero where not matched), matched (a valid left
    row with a right match) and is_left (a valid left row)."""

    key: U64
    lidx: torch.Tensor
    values: Table
    matched: torch.Tensor
    is_left: torch.Tensor


def join_fk_scan(left: Table, right: Table, lkey: U64, rkey: U64,
                 l_valid: torch.Tensor | None = None,
                 r_valid: torch.Tensor | None = None,
                 output: str = "left", backend: str = "radix"):
    """Foreign-key equi-join via one sort and forward fills.

    Right rows, then left rows, are sorted together by key; within a key
    the stable sort keeps right rows (in index order) before left rows (in
    index order), which is the JAX package's (key, side, index) order.
    With validity masks a 2-bit (side, valid) key follows, as the JAX
    sidekey orders invalid rows before valid ones of a side. Each left row
    then takes the last valid right row of its key segment, found by two
    running maxima (the last valid right position, and the segment
    start) in place of the JAX segmented fill scan: the same rows. Right
    keys should be unique; with duplicates the last right row in key order
    (the highest index) wins.

    output="left" returns (Table of left columns + right value columns,
    matched), aligned to the left row order; output="stream" returns the
    key-sorted merged stream (StreamJoinResult).
    """
    if output not in ("left", "stream"):
        raise ValueError(f"output must be 'left' or 'stream': {output!r}")
    n_l, n_r = lkey.lo.shape[0], rkey.lo.shape[0]
    n = n_l + n_r
    if n >= 1 << 30:
        raise ValueError("join_fk_scan supports up to 2^30 combined rows")
    dev = lkey.lo.device
    keys = [torch.cat([rkey.hi, lkey.hi]), torch.cat([rkey.lo, lkey.lo])]
    bits = [32, 32]
    masks = l_valid is not None or r_valid is not None
    if masks:
        rv = (torch.ones(n_r, dtype=torch.int32, device=dev)
              if r_valid is None else r_valid.to(torch.int32))
        lv = (torch.ones(n_l, dtype=torch.int32, device=dev)
              if l_valid is None else l_valid.to(torch.int32))
        keys.append(torch.cat([rv, 2 + lv]))    # side << 1 | valid
        bits.append(2)
    skeys, perm = argsort_planes(keys, bits, backend)
    shi, slo = skeys[0], skeys[1]
    perm = perm.to(torch.int64)
    side_right = perm < n_r
    valid_s = (skeys[2] & 1) > 0 if masks else torch.ones(
        n, dtype=torch.bool, device=dev)
    slidx = torch.where(side_right, perm, perm - n_r)

    pos = torch.arange(n, device=dev)
    is_new = ((pos == 0) | (slo != torch.roll(slo, 1))
              | (shi != torch.roll(shi, 1)))
    is_right = side_right & valid_s
    last_right = cummax_int64(torch.where(is_right, pos, -1))
    seg_start = cummax_int64(torch.where(is_new, pos, 0))
    fill_f = last_right >= seg_start
    src = perm[torch.clamp(last_right, min=0)]     # a right row's index

    def filled(c):          # right column values at each stream row
        if not n_r:         # no right row: every stream row is unmatched
            return _zero_column(c, n, dev)
        return take_column(c, torch.clamp(src, max=n_r - 1))

    if output == "stream":
        is_left = ~side_right & valid_s
        matched_s = fill_f & is_left
        cols = {nm: _mask(filled(right[nm]), matched_s) for nm in right}
        return StreamJoinResult(U64(slo, shi), slidx, Table(cols),
                                matched_s, is_left)

    # each left row's place in the stream
    where = torch.empty(n, dtype=torch.int64, device=dev)
    where[perm] = pos
    lpos = where[n_r:]
    matched = fill_f[lpos]
    if l_valid is not None:
        matched = matched & l_valid
    lsrc = torch.clamp(src[lpos], max=max(n_r - 1, 0))
    cols = _merge(left, _take(right, lsrc), lambda c: _mask(c, matched))
    return Table(cols), matched


class SortedJoinIndex(NamedTuple):
    """Join index for one-to-many joins of sorted tables."""

    start: torch.Tensor   # (n_left,) first matching right row
    end: torch.Tensor     # (n_left,) one past the last matching right row


def join_sorted(left_key: U64, right_key_sorted: U64) -> SortedJoinIndex:
    """Match ranges of each left key within a sorted right key column."""
    return SortedJoinIndex(
        searchsorted_u64(right_key_sorted, left_key, side="left"),
        searchsorted_u64(right_key_sorted, left_key, side="right"))


class InnerJoinResult(NamedTuple):
    """Materialized one-to-many inner join, padded to a static budget:
    slots [0, num_out) are real rows; num_out is exact even past the
    budget (overflow = 1, the columns then truncated)."""

    table: Table
    left_index: torch.Tensor
    right_index: torch.Tensor
    num_out: torch.Tensor
    overflow: torch.Tensor


def expand_ranges(ranges: SortedJoinIndex, out_budget: int):
    """Replicate [start, end) match ranges into `out_budget` output slots.

    For slot j: its left row i (offsets[i] <= j < offsets[i] + c_i) and
    right row start[i] + j - offsets[i]. The JAX package merges segment
    markers and slots with one sort and forward-fills (i, offsets[i]) by
    running maxima; the port writes each non-empty row's marker straight
    into its first slot (a scatter) and takes the same running maxima.

    Returns (left_index, right_index, num_out, overflow); slots past
    num_out hold clamped values (mask with arange < num_out).
    """
    start, end = ranges.start.to(torch.int64), ranges.end.to(torch.int64)
    n_l = start.shape[0]
    if not (out_budget >= 1 and n_l + out_budget < (1 << 30)):
        raise ValueError(f"bad out_budget {out_budget} for {n_l} rows")
    dev = start.device
    c = torch.clamp(end - start, min=0)
    total = c.sum()
    offsets = torch.cumsum(c, 0) - c
    marked = (c > 0) & (offsets < out_budget)
    slot = torch.where(marked, offsets, out_budget)   # out_budget: discard
    mark_i = torch.zeros(out_budget + 1, dtype=torch.int64, device=dev)
    mark_o = torch.zeros(out_budget + 1, dtype=torch.int64, device=dev)
    mark_i[slot] = torch.arange(1, n_l + 1, device=dev)
    mark_o[slot] = offsets + 1
    fill_i = cummax_int64(mark_i[:out_budget])   # i + 1
    fill_o = cummax_int64(mark_o[:out_budget])   # offsets[i] + 1
    li = torch.clamp(fill_i, min=1) - 1
    off = torch.clamp(fill_o, min=1) - 1
    j = torch.arange(out_budget, device=dev)
    ri = start[li] + (j - torch.minimum(off, j)) if n_l else j * 0
    overflow = (total > out_budget).to(torch.int64)
    return li, ri, total, overflow


def _slots(left: Table, right_s: Table, li, ri, num_out):
    """The output slots; with an empty side num_out is 0 and every slot
    reads zeros."""
    valid_out = torch.arange(li.shape[0], device=li.device) < num_out
    li = torch.where(valid_out, li, 0)
    ri = torch.where(valid_out, ri, 0)
    return li, ri, _merge(_take(left, li), _take(right_s, ri))


def join_inner(left: Table, right: Table, key: str = "key",
               out_budget: int | None = None,
               backend: str = "radix") -> InnerJoinResult:
    """One-to-many inner equi-join (duplicate right keys allowed) into a
    padded output of `out_budget` slots (default 2 * n_left), with the
    exact match count and an overflow flag. Traced as ops.join."""
    if not isinstance(right[key], U64):
        raise TypeError("join key must be u64")
    if out_budget is None:
        out_budget = max(2 * left.num_rows, 16)
    with span("ops.join"):
        right_sorted = right.sort_by(key, backend=backend)
        ranges = join_sorted(left[key], right_sorted[key])
        li, ri, num_out, overflow = expand_ranges(ranges, out_budget)
        li, ri, cols = _slots(left.drop(key), right_sorted.drop(key), li,
                              ri, num_out)
        return InnerJoinResult(Table(cols), li, ri, num_out, overflow)


def _sort_padded_right(right: Table, rkey: U64, r_valid, backend):
    """Right rows sorted by (key, invalid): each key's valid rows first."""
    inval = (~r_valid).to(torch.int32)
    (rhi, rlo, inval_s), perm = argsort_planes([rkey.hi, rkey.lo, inval],
                                               [32, 32, 1], backend)
    return U64(rlo, rhi), right.take(perm), inval_s == 0


def _valid_counts(ranges, valid_s):
    """Valid right rows in each [start, end) of the sorted right side."""
    pfx = torch.cat([torch.zeros(1, dtype=torch.int64,
                                 device=valid_s.device),
                     torch.cumsum(valid_s.to(torch.int64), 0)])
    return pfx[ranges.end] - pfx[ranges.start]


def join_inner_padded(left: Table, right: Table, lkey: U64, rkey: U64,
                      l_valid: torch.Tensor, r_valid: torch.Tensor,
                      out_budget: int,
                      backend: str = "radix") -> InnerJoinResult:
    """One-to-many inner join over padded inputs (validity-masked rows).

    The right side is sorted by (key, invalid flag), so each key's valid
    rows form its prefix; match counts are clipped to that prefix and
    invalid left rows match nothing. The JAX package sorts with an
    unstable sort, which leaves the order of duplicate right keys open;
    the port's sort keeps their input order.
    """
    rkey_s, right_s, valid_s = _sort_padded_right(right, rkey, r_valid,
                                                  backend)
    ranges = join_sorted(lkey, rkey_s)
    c = torch.where(l_valid, _valid_counts(ranges, valid_s), 0)
    li, ri, num_out, overflow = expand_ranges(
        SortedJoinIndex(ranges.start, ranges.start + c), out_budget)
    li, ri, cols = _slots(left, right_s, li, ri, num_out)
    return InnerJoinResult(Table(cols), li, ri, num_out, overflow)


class OuterJoinResult(NamedTuple):
    """Materialized one-to-many LEFT/FULL OUTER join, padded: unmatched
    left rows keep one slot (matched False, right columns zero); FULL adds
    the right rows no left key matches in `right_only`."""

    table: Table
    matched: torch.Tensor
    left_index: torch.Tensor
    right_index: torch.Tensor
    num_out: torch.Tensor
    overflow: torch.Tensor
    right_only: Table | None
    num_right_only: torch.Tensor | None


def _outer_slots(left: Table, right_s: Table, ranges, c, c_out,
                 out_budget):
    li, ri, num_out, overflow = expand_ranges(
        SortedJoinIndex(ranges.start, ranges.start + c_out), out_budget)
    valid_out = torch.arange(out_budget, device=li.device) < num_out
    # no left row: no slot is valid, and c has nothing to gather
    matched = (valid_out & (c[li] > 0) if c.numel()
               else torch.zeros_like(valid_out))
    li = torch.where(valid_out, li, 0)
    ri = torch.where(matched, ri, 0)
    # a slot that reads an empty side reads zeros, and is masked here
    lt = _take(left, li)
    cols = _merge(Table({nm: _mask(lt[nm], valid_out) for nm in lt}),
                  _take(right_s, ri), lambda c: _mask(c, matched))
    return Table(cols), matched, li, ri, num_out, overflow


def _right_only(right_s: Table, r_matched):
    """Right rows no left key matched, stably to the front, zero-padded."""
    m = r_matched.shape[0]
    n_ro = (~r_matched).sum(dtype=torch.int64)
    pos = torch.arange(m, device=r_matched.device)
    ro_valid = pos < n_ro
    perm = torch.where(ro_valid, stable_partition(~r_matched), 0)
    ro = right_s.take(perm)
    return Table({nm: _mask(ro[nm], ro_valid) for nm in ro}), n_ro


def join_outer(left: Table, right: Table, key: str = "key",
               how: str = "left", out_budget: int | None = None,
               backend: str = "radix") -> OuterJoinResult:
    """One-to-many LEFT or FULL OUTER equi-join.

    how="left": every left row appears, matched rows once per matching
    right row, unmatched rows once with matched=False and right columns
    zero. how="full" adds `right_only`: right rows whose key no left row
    has (sorted-key order, key column included, padded, exact count).
    Traced as ops.join, as join_inner.
    """
    if how not in ("left", "full"):
        raise ValueError(f"how must be 'left' or 'full': {how!r}")
    if not isinstance(right[key], U64):
        raise TypeError("join key must be u64")
    if out_budget is None:
        out_budget = max(2 * left.num_rows, 16)
    with span("ops.join"):
        return _join_outer(left, right, key, how, out_budget, backend)


def _join_outer(left, right, key, how, out_budget, backend):
    right_sorted = right.sort_by(key, backend=backend)
    lkey, rkey_sorted = left[key], right_sorted[key]
    ranges = join_sorted(lkey, rkey_sorted)
    c = ranges.end - ranges.start
    table, matched, li, ri, num_out, overflow = _outer_slots(
        left, right_sorted.drop(key), ranges, c, torch.clamp(c, min=1),
        out_budget)
    if how == "left":
        return OuterJoinResult(table, matched, li, ri, num_out, overflow,
                               None, None)
    (shi, slo), _ = argsort_planes([lkey.hi, lkey.lo], backend=backend)
    r_rng = join_sorted(rkey_sorted, U64(slo, shi))
    ro, n_ro = _right_only(right_sorted, r_rng.end > r_rng.start)
    return OuterJoinResult(table, matched, li, ri, num_out, overflow, ro,
                           n_ro)


def join_outer_padded(left: Table, right: Table, lkey: U64, rkey: U64,
                      l_valid: torch.Tensor, r_valid: torch.Tensor,
                      out_budget: int, full: bool = False,
                      backend: str = "radix") -> OuterJoinResult:
    """LEFT/FULL OUTER join over padded inputs: invalid left rows take no
    slot, valid unmatched left rows one NULL-right slot; FULL adds valid
    right rows matched by no valid left key (all-ones keys are reserved
    as pad sentinels). Duplicate right keys keep their input order (see
    join_inner_padded)."""
    rkey_s, right_s, valid_s = _sort_padded_right(right, rkey, r_valid,
                                                  backend)
    ranges = join_sorted(lkey, rkey_s)
    c = _valid_counts(ranges, valid_s)
    c_out = torch.where(l_valid, torch.clamp(c, min=1), 0)
    table, matched, li, ri, num_out, overflow = _outer_slots(
        left, right_s, ranges, c, c_out, out_budget)
    if not full:
        return OuterJoinResult(table, matched, li, ri, num_out, overflow,
                               None, None)
    # invalid left keys probe as all-ones sentinels
    plo = torch.where(l_valid, lkey.lo, -1)
    phi = torch.where(l_valid, lkey.hi, -1)
    (shi, slo), _ = argsort_planes([phi, plo], backend=backend)
    r_rng = join_sorted(rkey_s, U64(slo, shi))
    ro, n_ro = _right_only(right_s.with_column("_key", rkey_s),
                           (r_rng.end > r_rng.start) | ~valid_s)
    return OuterJoinResult(table, matched, li, ri, num_out, overflow, ro,
                           n_ro)
