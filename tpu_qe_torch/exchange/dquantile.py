"""Distributed exact quantiles with no row movement: the port of
tpu_qe/exchange/dquantile.py.

The (r+1)-th smallest element of sharded data is the largest value v with
count_lt(v) <= r; count_lt is monotone in v, so 64 (or 32) greedy bit
rounds find it, each round one search per shard over its locally sorted
rows and one psum of a (Q,) count vector. All Q quantiles ride the same
rounds, and every shard holds the same greedy state, so the answer needs
no gather. The greedy state stays on the device: no round reads anything
back to the host.

Per-group quantiles (GROUP BY key, PERCENTILE_DISC / CONT) sort each
shard's (key, value bits) rows once, gather the shards' distinct keys (at
most max_groups each, the only non-scalar traffic) into one replicated
group table, and run 32 rounds over the value domain for every (q, group)
at once.

The JAX shard sorts and compacts with sorts; the port sorts each shard's
rows once (``sort.planes.sort_planes``, B1-B3 on the card: all shards in
one sort, the shard as the most significant key) and counts with
``torch.searchsorted`` over an int64 view of the sorted rows: the 64-bit
key with its sign bit flipped (a signed order equal to the unsigned one),
and for the per-group search the row's local group index above its 32
value bits. Compactions are prefix sums and scatters.

One difference from the JAX package: its group table reads every
all-ones key as padding and drops that group; the port carries a validity
flag beside the keys, so a real all-ones key is a group like any other
(ROADMAP Queue C).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_qe_torch.bits import U64, narrow, sortable_u32, \
    sortable_u32_inverse, widen
from tpu_qe_torch.exchange.dsort import shard_column, shard_u64
from tpu_qe_torch.ops.aggregate import _shift_right_one
from tpu_qe_torch.ops.quantile import (ContQuantileResult, _cont_rank_device,
                                       _disc_rank_device, _interp_f32,
                                       _to_f32, canon_qs, cont_rank,
                                       disc_rank)
from tpu_qe_torch.sort.planes import argsort_planes
from tpu_qe_torch.table import column_to_numpy

I64_MIN = -(1 << 63)


class QuantileOverflow(RuntimeError):
    """Distinct group keys exceeded max_groups (exact detection; the
    caller may retry with a larger cap)."""


def _u64_key(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """int64 whose signed order is the unsigned order of the (lo, hi)
    pair: the u64 bit pattern with its sign bit flipped."""
    return ((hi.to(torch.int64) << 32) | widen(lo)) ^ I64_MIN


def _sort_shards(planes, bits, backend):
    """Each shard's rows of (S, n) int32 planes sorted by all of them
    (major first, unsigned, plane i by its low bits[i] bits): one stable
    sort, the shard as the most significant key. Returns (S, n) planes."""
    shards, n = planes[0].shape
    keys = [p.reshape(-1) for p in planes]
    if shards > 1:
        shard = torch.arange(shards, dtype=torch.int32,
                             device=keys[0].device).repeat_interleave(n)
        keys = [shard] + keys
        bits = [max((shards - 1).bit_length(), 1)] + list(bits)
    out, _ = argsort_planes(keys, bits, backend)
    return [p.reshape(shards, n) for p in out[len(out) - len(planes):]]


def _greedy(mesh, count, ranks: torch.Tensor, n_bits: int, offset=0):
    """The largest v per candidate with psum(count(v)) - offset <= rank,
    built bit by bit from the top (v in [0, 2^n_bits)).

    count(v) gives this shard's rows below candidate values v ((S, C)
    int64); ranks and offset are (S, C) int64. Returns (S, C) int64, the
    same on every shard."""
    p = torch.zeros_like(ranks)
    for b in range(n_bits - 1, -1, -1):
        c = p | ((1 << b) if b < 63 else I64_MIN)
        p = torch.where(mesh.psum(count(c)) - offset <= ranks, c, p)
    return p


def _dq(mesh, lo, hi, ranks, is_pair: bool, backend: str):
    """Global quantiles at host ranks: (S, Q) int64 values (the u64 bit
    pattern, or the 32-bit sortable bits), the same on every shard."""
    shards = lo.shape[0]
    if is_pair:
        shi, slo = _sort_shards([hi, lo], [32, 32], backend)
        skey = _u64_key(slo, shi)
        count = lambda c: torch.searchsorted(skey, c ^ I64_MIN)  # noqa: E731
    else:
        (slo,) = _sort_shards([lo], [32], backend)
        skey = widen(slo)
        count = lambda c: torch.searchsorted(skey, c)  # noqa: E731
    r = torch.tensor(ranks, dtype=torch.int64, device=lo.device).expand(
        shards, -1).contiguous()
    return _greedy(mesh, count, r, 64 if is_pair else 32)


def _check_rows(n: int) -> None:
    assert 0 < n < (1 << 32), n       # ranks and counts are u32


def distributed_quantile(col, qs, mesh, backend: str = "radix"):
    """Exact global PERCENTILE_DISC over a sharded column.

    col: U64 of (S, n_local) planes, or an (S, n_local) uint32 / int32 /
    float32 tensor (mesh.shard of the global column). Returns values in
    col's type, one per q: the same on every shard, row 0's returned."""
    spec = canon_qs(qs)
    if isinstance(col, U64):
        n = col.lo.numel() // col.lo.shape[0] * mesh.n_dev
        _check_rows(n)
        p = _dq(mesh, col.lo, col.hi, [disc_rank(num, sh, n)
                                        for num, sh in spec], True, backend)
        return U64(narrow(p[0]), narrow(p[0] >> 32))
    n = col.numel() // col.shape[0] * mesh.n_dev
    _check_rows(n)
    bits = sortable_u32(col)
    p = _dq(mesh, bits, bits, [disc_rank(num, sh, n) for num, sh in spec],
            False, backend)
    return sortable_u32_inverse(narrow(p[0]), col.dtype)


def distributed_quantile_cont(col, qs, mesh,
                              backend: str = "radix") -> ContQuantileResult:
    """Exact global PERCENTILE_CONT over a sharded column: the floor and
    ceil rank elements ride the same bisection (2Q candidates), the exact
    fractional numerators are host integers. Returns
    ops.quantile.ContQuantileResult (float32 interpolation for 32-bit
    columns; the exact fields only for U64)."""
    spec = canon_qs(qs)
    lo = col.lo if isinstance(col, U64) else col
    n = lo.numel() // lo.shape[0] * mesh.n_dev
    _check_rows(n)
    trip = [cont_rank(num, sh, n) for num, sh in spec]
    ranks = [r for f, c, _ in trip for r in (f, c)]
    fracs = tuple(fr for _, _, fr in trip)
    shifts = tuple(sh for _, sh in spec)
    if isinstance(col, U64):
        p = _dq(mesh, col.lo, col.hi, ranks, True, backend)[0]
        return ContQuantileResult(
            U64(narrow(p[0::2]), narrow(p[0::2] >> 32)),
            U64(narrow(p[1::2]), narrow(p[1::2] >> 32)), fracs, shifts,
            None)
    bits = sortable_u32(col)
    p = narrow(_dq(mesh, bits, bits, ranks, False, backend)[0])
    lower = sortable_u32_inverse(p[0::2], col.dtype)
    upper = sortable_u32_inverse(p[1::2], col.dtype)
    return ContQuantileResult(lower, upper, fracs, shifts, _interp_f32(
        lower, upper, [fr / (1 << sh) for fr, sh in zip(fracs, shifts)]))


def distributed_quantile_cont_numpy(vals: np.ndarray, qs, mesh, **kw
                                    ) -> ContQuantileResult:
    """Host wrapper for distributed_quantile_cont over a numpy column."""
    return distributed_quantile_cont(shard_column(vals, mesh), qs, mesh,
                                     **kw)


def distributed_quantile_numpy(vals: np.ndarray, qs, mesh, **kw):
    """Host wrapper: shard a numpy column, return numpy quantiles."""
    return column_to_numpy(distributed_quantile(shard_column(vals, mesh),
                                                qs, mesh, **kw))


# --------------------------------------------------------------------------
# per-group distributed quantiles (GROUP BY key, PERCENTILE_DISC(q))
# --------------------------------------------------------------------------

def _compact(flags: torch.Tensor, values, fills, k: int):
    """The rows where `flags` is set, in order, into (S, k) planes padded
    with `fills` (rows past the k-th dropped): a prefix sum and a
    scatter."""
    shards = flags.shape[0]
    slot = torch.cumsum(flags.to(torch.int64), 1) - 1
    slot = torch.where(flags & (slot < k), slot, k)
    outs = []
    for v, f in zip(values, fills):
        o = torch.full((shards, k + 1), f, dtype=v.dtype, device=v.device)
        o.scatter_(1, slot, v)
        outs.append(o[:, :k])
    return outs


def _group_table(mesh, slo, shi, max_groups: int, backend: str):
    """The replicated group table: (gklo, gkhi, g_valid, n_groups,
    overflow). Each shard's distinct keys (at most k = min(max_groups,
    n_local), with a validity flag) are gathered, sorted (pads last) and
    deduplicated; the first max_groups form the table."""
    shards, n_local = slo.shape
    dev = slo.device
    is_new = torch.ones_like(slo, dtype=torch.bool)
    is_new[:, 1:] = (slo[:, 1:] != slo[:, :-1]) | (shi[:, 1:] != shi[:, :-1])
    m_local = is_new.sum(1)
    k = min(max_groups, n_local)
    glo, ghi, gpad = _compact(is_new, [slo, shi, torch.zeros_like(slo)],
                              [-1, -1, 1], k)
    # the union over shards (every shard computes the same table)
    ulo, uhi, upad = (mesh.all_gather(x)[0] for x in (glo, ghi, gpad))
    (spad, suhi, sulo), _ = argsort_planes([upad, uhi, ulo], [1, 32, 32],
                                           backend)
    u_new = (spad == 0) & (
        (_shift_right_one(sulo, 0) != sulo) | (_shift_right_one(suhi, 0)
                                               != suhi))
    u_new[0] = spad[0] == 0
    n_groups = u_new.sum()
    gklo, gkhi = _compact(u_new[None], [sulo[None], suhi[None]], [-1, -1],
                          max_groups)
    g_valid = torch.arange(max_groups, device=dev) < n_groups
    # overflow: the union passed the bound, or a shard had to truncate its
    # local distinct keys (the union would then undercount)
    overflow = torch.maximum(
        (n_groups > max_groups).to(torch.int64),
        mesh.pmax((m_local > k).to(torch.int64))[0])
    return gklo[0], gkhi[0], g_valid, n_groups, overflow


def _dgq(mesh, lo, hi, v, spec, max_groups: int, cont: bool, backend):
    """Per-group bisection (the JAX _dgq_shard). Returns (gklo, gkhi,
    p (q_n, G) int64 value bits, cnt (G,), n_groups, overflow, fracs
    (Q, G) or None, g_valid (G,))."""
    shards, n_local = lo.shape
    dev = lo.device
    _check_rows(n_local * mesh.n_dev)
    shi, slo, sv = _sort_shards([hi, lo, v], [32, 32, 32], backend)
    key = _u64_key(slo, shi)
    is_new = torch.ones_like(slo, dtype=torch.bool)
    is_new[:, 1:] = key[:, 1:] != key[:, :-1]
    # (local group index, value bits): ascending along each shard
    comb = ((torch.cumsum(is_new.to(torch.int64), 1) - 1) << 32) | widen(sv)
    gklo, gkhi, g_valid, n_groups, overflow = _group_table(
        mesh, slo, shi, max_groups, backend)
    # where each group key starts on this shard, and its local index
    gkey = _u64_key(gklo, gkhi).expand(shards, -1).contiguous()
    at = torch.searchsorted(key, gkey)                       # (S, G)
    atc = torch.clamp(at, max=n_local - 1)
    here = key.gather(1, atc) == gkey
    gidx = (comb.gather(1, atc) >> 32)

    def count_lt(vals, right=False):
        """Rows below (key, vals) (or at most, with right): (S, C) for
        vals (S, C) int64 value bits over C = reps * G candidates."""
        reps = vals.shape[1] // max_groups
        g = gidx.repeat(1, reps)
        inner = torch.searchsorted(comb, (g << 32) | vals, right=right)
        return torch.where(here.repeat(1, reps), inner, at.repeat(1, reps))

    zeros = torch.zeros(shards, max_groups, dtype=torch.int64, device=dev)
    start = mesh.psum(count_lt(zeros))
    cnt = mesh.psum(count_lt(zeros + 0xFFFFFFFF, right=True)) - start
    fracs = None
    if cont:
        rows, frac_rows = [], []
        for num, sh in spec:
            f, c, frac = _cont_rank_device(num, sh, cnt)
            rows += [f, c]
            frac_rows.append(frac)
        fracs = torch.stack(frac_rows, 1)[0]                 # (Q, G)
    else:
        rows = [_disc_rank_device(num, sh, cnt) for num, sh in spec]
    q_n = len(rows)
    p = _greedy(mesh, count_lt, torch.cat(rows, 1), 32,
                offset=start.repeat(1, q_n))
    p = p[0].reshape(q_n, max_groups)
    return gklo, gkhi, p, cnt[0], n_groups, overflow, fracs, g_valid


def _masked(x, g_valid):
    return torch.where(g_valid, x, 0)


def distributed_group_quantile(key: U64, value, qs, mesh, max_groups: int,
                               backend: str = "radix"):
    """Per-group exact PERCENTILE_DISC over sharded rows with no row
    movement: one local (key, value) sort per shard, one all_gather of the
    bounded distinct-key table, then 32 rounds of a local search and one
    (Q * G,) psum.

    key: U64 of (S, n_local) planes; value: (S, n_local) uint32 / int32 /
    float32. Returns (key: U64 padded to max_groups, quantiles (Q,
    max_groups) in the value dtype, count (max_groups,) int64, num_groups
    and overflow, 0-d int64), the same on every shard; entries past
    num_groups are all-ones keys and zeros. overflow != 0 means the
    distinct keys exceeded max_groups (outputs truncated, never silently
    wrong)."""
    spec = canon_qs(qs)
    gklo, gkhi, p, cnt, ng, ovf, _, g_valid = _dgq(
        mesh, key.lo, key.hi, sortable_u32(value), spec, max_groups, False,
        backend)
    vals = sortable_u32_inverse(narrow(_masked(p, g_valid)), value.dtype)
    return U64(gklo, gkhi), vals, _masked(cnt, g_valid), ng, ovf


def distributed_group_quantile_cont(key: U64, value, qs, mesh,
                                    max_groups: int,
                                    backend: str = "radix"):
    """Per-group exact PERCENTILE_CONT over sharded rows with no row
    movement: the floor and ceil rank elements of every (group, q) ride
    the same 32 rounds and the exact fractional numerators come back as a
    (Q, G) plane.

    Returns (key, lower (Q, G) in the value dtype, upper, frac (Q, G)
    int64, shifts, value (Q, G) float32 interpolation, count, num_groups,
    overflow), the same on every shard; the exact answer is lower +
    (upper - lower) * frac / 2^shift per (q, group)."""
    spec = canon_qs(qs)
    gklo, gkhi, p, cnt, ng, ovf, fracs, g_valid = _dgq(
        mesh, key.lo, key.hi, sortable_u32(value), spec, max_groups, True,
        backend)
    p = _masked(p, g_valid)
    lower = sortable_u32_inverse(narrow(p[0::2]), value.dtype)
    upper = sortable_u32_inverse(narrow(p[1::2]), value.dtype)
    frac = _masked(fracs, g_valid)
    lo_f = _to_f32(lower)
    scale = torch.tensor([1.0 / (1 << sh) for _, sh in spec],
                         dtype=torch.float32, device=lo_f.device)[:, None]
    val = lo_f + (_to_f32(upper) - lo_f) * frac.to(torch.float32) * scale
    return (U64(gklo, gkhi), lower, upper, frac,
            tuple(sh for _, sh in spec), val, _masked(cnt, g_valid), ng, ovf)


def _group_dict(gk: U64, vals: torch.Tensor, ng: int) -> dict:
    keys = gk.to_numpy()[:ng]
    v = column_to_numpy(vals)[:, :ng]
    return {int(k): list(v[:, i]) for i, k in enumerate(keys)}


def distributed_group_quantile_numpy(keys, values, qs, mesh, max_groups: int,
                                     **kw):
    """Host wrapper: {key -> [q values...]} over all shards."""
    gk, vals, _, ng, ovf = distributed_group_quantile(
        shard_u64(keys, mesh), shard_column(np.asarray(values), mesh), qs,
        mesh, max_groups, **kw)
    if int(ovf):
        raise QuantileOverflow("distinct keys exceed max_groups")
    return _group_dict(gk, vals, int(ng))


def distributed_group_quantile_cont_numpy(keys, values, qs, mesh,
                                          max_groups: int, **kw):
    """Host wrapper for distributed_group_quantile_cont: {key -> [float32
    interpolated PERCENTILE_CONT per q]} over all shards (the exact
    rational fields stay on the device API)."""
    gk, _lo, _up, _fr, _sh, v, _cnt, ng, ovf = \
        distributed_group_quantile_cont(
            shard_u64(keys, mesh), shard_column(np.asarray(values), mesh),
            qs, mesh, max_groups, **kw)
    if int(ovf):
        raise QuantileOverflow("distinct keys exceed max_groups")
    return _group_dict(gk, v, int(ng))
