"""Distributed window functions over a mesh of shards: the port of
tpu_qe/exchange/dwindow.py.

A window function is a segmented scan over the (partition, order,
position)-sorted stream, and segmented scans compose across any block
boundary through a monoid carry:

1.  rows are sorted globally by (key, order, position) with the splitter
    exchange (exchange/shuffle.py): splitters over the full window order
    with the unique position last split a hot partition across
    consecutive shards, which is the case the carry chain exists for;
2.  each shard computes its local window planes with a forced segment
    start at its first row, so that its tail partition's running values
    are the fold elements the cross-shard combine needs;
3.  one all_gather of O(D) per-shard summary scalars (first and last key,
    boundary order values, tail counts, ranks and aggregates, edge values
    for lag / lead) feeds a D-step carry chain, and the carries patch only
    the rows of each shard's boundary partitions;
4.  moving frames and lag / lead with an offset k > 1 reach k rows into
    the neighbouring shards: a tail halo (the last H valid rows over the
    preceding shards) and a head halo (the first Hf valid rows over the
    following ones) are gathered and the frames computed over the
    halo-extended stream are exact without a patch; averages divide the
    patched sums by the global denominators; tie-aware RANGE frames add a
    backward chain over the order run that continues on later shards.

The port runs every local step once over all S shards of a LocalMesh: the
(S, run) planes are one stream with a forced segment start at each shard's
first row, which is the JAX package's per-device computation for every
shard at once. The carry chain runs once over the gathered (D, F) summary
(every rank of a GroupMesh runs it, as every JAX device does) and each
shard takes its own row. The JAX shard sorts its whole receive layout by
(key, order, pad flag above the stability rank); the port sorts each
shard's received real rows by (key, order, stability rank) and puts them
at the front of the run (exchange.dsort.sort_real_rows): the same rows,
since the rank is unique, and every pad after them. The head halo is
placed at each shard's valid count by an index scatter with the counts on
the device.

Integer running, moving, total and RANGE sums are int64 (two's
complement mod 2^64, the JAX package's u64 pairs) across shards, exact
bit for bit. float32 sums are not bit-exact across a forced segment start:
the shard's prefix restarts there and rounds otherwise than the one-shard
prefix (and the port's blocked scans run over one stream of all shards);
they agree within the reference's stated tolerance.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_qe_torch.bits import U64, narrow, sortable_u32, widen
from tpu_qe_torch.exchange.dsort import (_global_pos, shard_column,
                                         shard_u64, sort_real_rows)
from tpu_qe_torch.exchange.shuffle import (ONES, exchange, offdiag_demand,
                                           pow2_capacity,
                                           route_by_splitters_multi,
                                           sample_splitters_multi)
from tpu_qe_torch.ops.aggregate import _ends, _shift_right_one
from tpu_qe_torch.ops.window import (_MOVING, _RANGE, _RUNNING, _Extent,
                                     _canon_funcs, _fill_plane, _moving,
                                     _moving_follow, _pair, _pair_to_f32,
                                     _shift_k, _u32, _window_sorted_cols)
from tpu_qe_torch.table import column_to_numpy, from_plane, plane

_TOTALS = ("total_sum", "total_min", "total_max")
_CNT_KINDS = ("ntile", "percent_rank", "partition_count", "total_avg",
              "moving_count")
_AVG = {"total_avg": "total_sum", "running_avg": "running_sum",
        "range_avg": "range_sum"}
_SUMS = ("running_sum", "total_sum", "range_sum")


class DistWindowResult(NamedTuple):
    """Padded per-shard (key, order, position)-sorted runs, (S, run); run
    is the most real rows a shard of the mesh received (at least 1).

    Shard s's run: the first valid[s] rows ((S,) int64) are real, globally
    sorted when the runs concatenate in mesh order. `pos` (int64) maps each
    row to its global input position (scatter by pos to restore the input
    order). cols: out_name -> (S, run) column (U64 for integer sums).
    """

    key: U64
    pos: torch.Tensor
    cols: dict
    valid: torch.Tensor


def _enc(x: torch.Tensor) -> torch.Tensor:
    """A u32 / i32 / f32 column as int64: u32 and i32 values (ordered and
    exact), f32 bits (decoded for arithmetic by _dec)."""
    if x.dtype == torch.int32:
        return x.to(torch.int64)
    return widen(x.view(torch.int32))


def _dec(e: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.int32:
        return narrow(e)
    return narrow(e).view(dtype)


def _minmax(kind: str, a: torch.Tensor, b: torch.Tensor, dtype):
    """min or max (by the kind's suffix) of two _enc carriers."""
    op = torch.minimum if kind.endswith("min") else torch.maximum
    if dtype == torch.float32:
        return _enc(op(_dec(a, dtype), _dec(b, dtype)))
    return op(a, b)


def _i64(u: U64) -> torch.Tensor:
    """The int64 (mod 2^64) of a U64 sum pair."""
    return (u.hi.to(torch.int64) << 32) | widen(u.lo)


def _haloed(s) -> bool:
    # lag / lead with an offset k > 1 (a (fill, k) pair in the fill slot)
    # come from the row halos, not from the scalar chain
    return s[1] in ("lag", "lead") and isinstance(s[3], tuple)


def _route(mesh, lo, hi, obits, n_dev, samples_per_dev, backend):
    """(gpos, dest): routing on the full window order (key, [order,]
    position). dsort's (key, position) splitters would split a partition
    by position while its window order is (order, position)."""
    gpos = _global_pos(mesh, lo.shape[1], lo.device)
    planes = [hi, lo] + ([] if obits is None else [obits]) + [gpos]
    sps = sample_splitters_multi(mesh, planes, n_dev, samples_per_dev,
                                 backend)
    return gpos, route_by_splitters_multi(planes, sps)


class _Stream:
    """The (S, L) shard runs as one stream of S * L rows: flat index,
    shard of each row, local index, and per-row views of per-shard
    values."""

    def __init__(self, shards: int, width: int, device):
        self.idx = torch.arange(shards * width, device=device)
        self.shard = self.idx // width
        self.base = torch.arange(shards, device=device) * width
        self.loc = self.idx - self.base[self.shard]

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """(S,) per-shard values -> one per row."""
        return x[self.shard]


def _segment_starts(lo, hi, width: int) -> torch.Tensor:
    """Segment starts of a flat stream of (S, width) blocks: each block's
    first row and every key change."""
    idx = torch.arange(lo.shape[0], device=lo.device)
    return ((idx % width == 0) | (lo != _shift_right_one(lo, 0))
            | (hi != _shift_right_one(hi, 0)))


def _cut(x, lead: int, width: int, total: int):
    """Rows [lead, lead + width) of each (S, total) block of a flat
    column, flat again."""
    def one(p):
        return p.reshape(-1, total)[:, lead:lead + width].reshape(-1)
    return U64(one(x.lo), one(x.hi)) if isinstance(x, U64) else one(x)


def _dwindow_shard(mesh, lo, hi, obits, vals: dict, *, n_dev: int,
                   samples_per_dev: int, capacity: int, spec: tuple,
                   backend: str):
    """Shard body: exchange + local window + carry chain + patch."""
    shards, n_local = lo.shape
    dev = lo.device
    has_order = obits is not None
    n_ord = int(has_order)
    colnames = tuple(sorted(vals))
    dtypes = {c: vals[c].dtype for c in colnames}
    gpos, dest = _route(mesh, lo, hi, obits, n_dev, samples_per_dev,
                        backend)
    cols = ([lo, hi] + ([obits] if has_order else []) + [gpos]
            + [plane(vals[c]) for c in colnames])
    pads = [ONES] * (2 + n_ord) + [0] * (1 + len(colnames))
    recv, flag, rank, counts, overflow = exchange(
        mesh, dest, cols, pads, n_dev, capacity, backend)
    m_stride = max(capacity, n_local)
    keys = [recv[1], recv[0]] + ([recv[2]] if has_order else [])
    n_v = counts.sum(1)                                     # (S,)
    # runs as wide as the most real rows a shard of the mesh received (the
    # sweeps below run over every slot; the same width on every rank)
    skeys, _, rest = sort_real_rows(
        flag, keys, [ONES] * len(keys), rank,
        (n_dev * m_stride - 1).bit_length(), recv[2 + n_ord:],
        [0] * (1 + len(colnames)), max(int(mesh.pmax(n_v).max()), 1),
        backend)
    del recv, flag, rank, keys
    L = skeys[0].shape[1]
    st = _Stream(shards, L, dev)
    idx = st.idx
    shi, slo = skeys[0].reshape(-1), skeys[1].reshape(-1)
    sorder = skeys[2].reshape(-1) if has_order else None
    spos = rest[0]
    svals = {c: from_plane(p.reshape(-1), dtypes[c])
             for c, p in zip(colnames, rest[1:])}
    del skeys, rest
    spad = st.loc >= st.rows(n_v)
    first = st.loc == 0
    is_new = (_segment_starts(slo, shi, L)
              | (spad & ~_shift_right_one(spad, False)))  # pads: a segment
    order_new = is_new if sorder is None else (
        is_new | (sorder != _shift_right_one(sorder, 0)))
    is_last = _ends(is_new)

    spec_calc = tuple((nm, _AVG.get(k, k), c, f) for nm, k, c, f in spec)
    base_spec = tuple(s for s in spec_calc
                      if s[1] not in _MOVING and not _haloed(s))
    out, aux = _window_sorted_cols(base_spec, svals, idx, is_new, order_new,
                                   is_last, need_aux=True)
    ext = _Extent(idx, is_new, order_new, is_last)
    part_start, run_start = aux["part_start"], aux["run_start"]
    has_cnt = any(k in _CNT_KINDS for _, k, _, _ in spec)
    part_end = None if not has_cnt else (
        aux["part_end"] if aux["part_end"] is not None else ext.part_end)
    any_range = any(k in _RANGE for _, k, _, _ in spec_calc)
    any_range_avg = any(k == "range_avg" for _, k, _, _ in spec)
    # tie-aware RANGE frames run through the end of the row's order run
    t_idx = ext.run_end if any_range else None

    # ---- moving frames and lag offset k: the tail halo ----------------
    # every shard gathers every shard's last H valid rows and takes the
    # last H valid rows over its predecessors (a predecessor with fewer
    # than H rows gives what it has, so the halo is exact for any skew),
    # prepends them, and computes the frames over the concatenation: the
    # halo rows carry their real keys, so frames clamp at the true
    # partition starts and the results need no patch
    my = mesh.ranks()
    devs = torch.arange(n_dev, device=dev)

    def gather_rows(at, valid, cols_):
        """(S, D, P, W) of every shard's rows `at` ((S, W) local
        indices) of [lo, hi, *cols_ planes] and their validity."""
        flat = (torch.clamp(at, max=L - 1) + st.base[:, None]).reshape(-1)
        planes = [slo[flat], shi[flat]] + [
            plane(svals[c])[flat] for c in cols_]
        planes.append(valid.reshape(-1).to(torch.int32))
        x = torch.stack(planes).reshape(len(planes), shards, -1)
        return mesh.all_gather(x.transpose(0, 1)[:, None].contiguous())

    def valid_ordinals(gt, take):
        """Running count of the valid gathered rows of the shards in
        `take` ((S, D)), in shard order: (S, D * W), and its total."""
        vf = ((gt[:, :, -1, :] > 0) & take[:, :, None]).reshape(shards, -1)
        cum = torch.cumsum(vf.to(torch.int64), 1)
        return cum, cum[:, -1:]

    def halo_pick(gt, cum, tgt, have):
        """The rows of the (S, D, P, W) gather at valid-row ordinals
        `tgt` ((S, W), 1-based; fill where not `have`)."""
        src = torch.clamp(torch.searchsorted(cum, torch.where(have, tgt, 0)),
                          max=cum.shape[1] - 1)

        def pick(pi, fill):
            x = gt[:, :, pi, :].reshape(shards, -1).gather(1, src)
            return torch.where(have, x, fill)
        return pick

    mov_spec = tuple(s for s in spec_calc
                     if s[1] in _MOVING and not isinstance(s[3], tuple))
    movF_spec = tuple(s for s in spec_calc
                      if s[1] in _MOVING and isinstance(s[3], tuple))
    lagk_spec = tuple(s for s in spec_calc
                      if s[1] == "lag" and isinstance(s[3], tuple))
    leadk_spec = tuple(s for s in spec_calc
                       if s[1] == "lead" and isinstance(s[3], tuple))
    H = 0
    h_lo = h_hi = None
    h_vals = {}
    if mov_spec or lagk_spec or movF_spec:
        H = max([int(f) - 1 for _, _, _, f in mov_spec]
                + [int(f[1]) for _, _, _, f in lagk_spec]
                + [int(f[0]) - 1 for _, _, _, f in movF_spec])
        mcols = tuple(sorted({s[2] for s in mov_spec + lagk_spec
                              + movF_spec}))
        c_lo, c_hi = slo, shi
        if H > 0:
            h = torch.arange(H, device=dev)
            tpos = torch.clamp(n_v - H, min=0)[:, None] + h
            gt = gather_rows(tpos, tpos < n_v[:, None], mcols)
            cum, v_tot = valid_ordinals(gt, devs[None] < my[:, None])
            have = (h + v_tot) >= H
            pick = halo_pick(gt, cum, v_tot - H + h + 1, have)
            h_lo, h_hi = pick(0, -1), pick(1, -1)
            h_vals = {c: pick(2 + i, 0) for i, c in enumerate(mcols)}

            def with_halo(x, halo):
                return torch.cat([halo, x.reshape(shards, L)], 1).reshape(-1)
            c_lo, c_hi = with_halo(slo, h_lo), with_halo(shi, h_hi)
        Lc = H + L
        c_new = _segment_starts(c_lo, c_hi, Lc)
        cidx = torch.arange(c_lo.shape[0], device=dev)
        cext = _Extent(cidx, c_new, c_new, _ends(c_new))

        def c_col(col):
            p = plane(svals[col])
            if H > 0:
                p = with_halo(p, h_vals[col])
            return from_plane(p, dtypes[col])

        for name, kind, col, fill in mov_spec:
            mv = _moving(kind, c_col(col), int(fill), c_new, cext.rn0, cext)
            out[name] = _cut(mv, H, L, Lc)
        for name, kind, col, fill in lagk_spec:
            f_, k_ = fill
            cv = c_col(col)
            fp = _fill_plane(f_, cv.dtype)
            lg = torch.where(cext.rn0 >= k_, _shift_k(plane(cv), k_, fp),
                             fp)
            out[name] = _cut(from_plane(lg, cv.dtype), H, L, Lc)

    # ---- lead offset k and FOLLOWING frames: the head halo -----------
    # the first Hf valid rows over the successors, placed at each shard's
    # valid count (an index scatter over its pad slots), so that a shift
    # left reads the true following rows; a shifted-key equality clamps
    # at partition ends (missing rows carry all-ones keys)
    if leadk_spec or movF_spec:
        Hf = max([int(f[1]) for _, _, _, f in leadk_spec + movF_spec])
        fcols = tuple(sorted({s[2] for s in leadk_spec + movF_spec}))
        h2 = torch.arange(Hf, device=dev)
        gt2 = gather_rows(h2.expand(shards, -1), h2 < n_v[:, None], fcols)
        cum2, v_tot2 = valid_ordinals(gt2, devs[None] > my[:, None])
        have2 = h2 < v_tot2
        pick2 = halo_pick(gt2, cum2, h2 + 1, have2)
        at = n_v[:, None] + h2

        def place(p, halo, padv):
            e = torch.cat([p.reshape(shards, L), torch.full(
                (shards, Hf), padv, dtype=p.dtype, device=dev)], 1)
            return e.scatter_(1, at, halo).reshape(-1)

        E = L + Hf
        e_lo, e_hi = place(slo, pick2(0, -1), -1), place(shi, pick2(1, -1),
                                                         -1)
        placed = {c: place(plane(svals[c]), pick2(2 + i, 0), 0)
                  for i, c in enumerate(fcols)}
        for name, kind, col, fill in leadk_spec:
            f_, k_ = fill
            fp = _fill_plane(f_, dtypes[col])
            tail = torch.zeros(k_, dtype=torch.int32, device=dev)
            nxt = torch.cat([placed[col][k_:], tail + fp])
            same = ((torch.cat([e_lo[k_:], tail]) == e_lo)
                    & (torch.cat([e_hi[k_:], tail]) == e_hi))
            out[name] = _cut(from_plane(torch.where(same, nxt, fp),
                                        dtypes[col]), 0, L, E)
        # FOLLOWING frames over [tail halo (H); valid rows; head halo]:
        # the backward reach rides the tail halo, the forward one the head
        # halo, and a valid row's forward reach never touches its own pads
        if movF_spec:
            def x_of(p, halo):
                if H == 0:
                    return p
                return torch.cat([halo, p.reshape(shards, E)], 1).reshape(-1)
            M = H + E
            x_lo, x_hi = x_of(e_lo, h_lo), x_of(e_hi, h_hi)
            x_new = _segment_starts(x_lo, x_hi, M)
            xext = _Extent(torch.arange(x_lo.shape[0], device=dev), x_new,
                           x_new, _ends(x_new))
            for name, kind, col, fill in movF_spec:
                kk, bb = fill
                xv = from_plane(x_of(placed[col], h_vals.get(col)),
                                dtypes[col])
                mv = _moving_follow(kind, xv, int(kk), int(bb), xext)
                out[name] = _cut(mv, H, L, M)

    # ---- per-shard summary vector --------------------------------------
    li = torch.clamp(n_v, min=1) - 1                        # last valid row
    last, head_row = st.base + li, st.base
    tps = part_start[last] - st.base
    trs = run_start[last] - st.base
    summ, names = [], []

    def put(name, val):
        names.append(name)
        summ.append(val.to(torch.int64))

    put("nv", n_v)
    put("fk_lo", widen(slo[head_row]))
    put("fk_hi", widen(shi[head_row]))
    put("lk_lo", widen(slo[last]))
    put("lk_hi", widen(shi[last]))
    if has_order:
        put("fo", widen(sorder[head_row]))
        put("lo_", widen(sorder[last]))
    put("tps", tps)
    put("tail_cnt", li - tps + 1)
    put("trs_zero", trs == 0)
    put("tail_rank", trs - tps + 1)
    if has_cnt:
        # valid rows of the head partition (pads are their own segment)
        put("hcnt", part_end[head_row] - st.base + 1)
    if any_range_avg:
        put("hrc", t_idx[head_row] - st.base + 1)   # the head run's rows

    def int_sum(kind, col):
        return kind in _SUMS and dtypes[col] != torch.float32

    for name, kind, col, fill_ in spec_calc:
        o = out.get(name)
        if kind == "dense_rank":
            put(f"td:{name}", _enc(o)[last])
        elif int_sum(kind, col) or kind in _RUNNING + _TOTALS + (
                "range_sum", "range_min", "range_max"):
            e = _i64(o) if int_sum(kind, col) else _enc(o)
            # at the last row: the partition-prefix fold element
            put(f"ta:{name}", e[last])
            if kind in _TOTALS:     # backward chain: head-partition total
                put(f"ha:{name}", e[head_row])
            if kind.startswith("range_"):   # backward chain: head run
                put(f"hr:{name}", e[head_row])
        elif kind == "lag" and not isinstance(fill_, tuple):
            put(f"lv:{name}", _enc(svals[col])[last])
        elif kind == "lead" and not isinstance(fill_, tuple):
            put(f"fv:{name}", _enc(svals[col])[head_row])
        elif kind == "first_value":
            # the tail partition's local first value (chain origin)
            put(f"tfv:{name}", _enc(svals[col])[st.base + tps])
        elif kind == "last_value":
            # the head partition's local last value
            put(f"hlv:{name}", _enc(o)[head_row])
    g = mesh.all_gather(torch.stack(summ, 1)[:, None])[0]   # (D, F)
    col_of = {nm: i for i, nm in enumerate(names)}

    def gv(e, nm):
        return g[e, col_of[nm]]

    # ---- carry chain over the shards (D static: a Python fold) --------
    u0 = torch.zeros((), dtype=torch.int64, device=dev)
    ex = torch.zeros((), dtype=torch.bool, device=dev)
    plk_lo = plk_hi = plord = C_cnt = C_dense = C_rank = u0
    pvals = {nm: u0 for nm, k, _, f in spec_calc
             if k == "lag" and not isinstance(f, tuple)}
    # range kinds ride the same forward partition-prefix carry as the
    # running family; the run-suffix patch they need is the backward
    # S_run chain
    _MMLIKE = _RUNNING + _TOTALS + ("range_min", "range_max")
    C_agg = {nm: u0 for nm, k, _, _ in spec_calc
             if k in _MMLIKE or k == "range_sum"}
    C_first = {nm: u0 for nm, k, _, _ in spec if k == "first_value"}
    rec = {k: [] for k in ("cont", "cont_o", "C_cnt", "C_dense", "C_rank")}
    rec_agg = {nm: [] for nm in C_agg}
    rec_lag = {nm: [] for nm in pvals}
    rec_first = {nm: [] for nm in C_first}

    def fsum(a, b, kind, col):
        """a + b of two sum carriers: int64 (mod 2^64) or f32 bits."""
        if int_sum(kind, col):
            return a + b
        return _enc(_dec(a, torch.float32) + _dec(b, torch.float32))

    def combine(kind, col, a, b):
        if kind in _SUMS:
            return fsum(a, b, kind, col)
        return _minmax(kind, a, b, dtypes[col])

    for e in range(n_dev):
        nonempty = gv(e, "nv") > 0
        cont = (ex & nonempty & (gv(e, "fk_lo") == plk_lo)
                & (gv(e, "fk_hi") == plk_hi))
        cont_o = (cont & (gv(e, "fo") == plord)) if has_order else cont
        rec["cont"].append(cont)
        rec["cont_o"].append(cont_o)
        rec["C_cnt"].append(C_cnt)
        rec["C_dense"].append(C_dense)
        rec["C_rank"].append(C_rank)
        for nm in C_agg:
            rec_agg[nm].append(C_agg[nm])
        for nm in pvals:
            rec_lag[nm].append(pvals[nm])
        for nm in C_first:
            rec_first[nm].append(C_first[nm])

        whole = cont & (gv(e, "tps") == 0)   # tail partition spans shard
        wc = torch.where(whole, C_cnt, u0)
        nC_cnt = gv(e, "tail_cnt") + wc
        nC_rank = torch.where(
            gv(e, "trs_zero") == 0, gv(e, "tail_rank") + wc,
            torch.where(cont_o, C_rank,
                        gv(e, "tail_rank") + torch.where(cont, C_cnt, u0)))
        nC_dense = C_dense
        nC_agg = {}
        for name, kind, col, _ in spec_calc:
            if kind == "dense_rank":
                nC_dense = gv(e, f"td:{name}") + torch.where(
                    whole, C_dense - cont_o.to(torch.int64), u0)
            elif name in C_agg:
                tv = gv(e, f"ta:{name}")
                nC_agg[name] = torch.where(
                    whole, combine(kind, col, C_agg[name], tv), tv)

        def upd(new, old):
            return torch.where(nonempty, new, old)
        C_cnt = upd(nC_cnt, C_cnt)
        C_rank = upd(nC_rank, C_rank)
        C_dense = upd(nC_dense, C_dense)
        for nm in C_first:
            # keep the origin's first value while the tail partition
            # merely continues through this shard
            C_first[nm] = upd(torch.where(whole, C_first[nm],
                                          gv(e, f"tfv:{nm}")), C_first[nm])
        for nm in C_agg:
            C_agg[nm] = upd(nC_agg[nm], C_agg[nm])
        plk_lo = upd(gv(e, "lk_lo"), plk_lo)
        plk_hi = upd(gv(e, "lk_hi"), plk_hi)
        if has_order:
            plord = upd(gv(e, "lo_"), plord)
        for nm in pvals:
            pvals[nm] = upd(gv(e, f"lv:{nm}"), pvals[nm])
        ex = ex | nonempty

    # reverse chain: does the next non-empty shard continue my tail
    # partition, and with what first value (lead)? The whole-partition
    # functions ride it too: the continuing partition's global last value,
    # its row count on later shards, its total's suffix, and the suffix of
    # my tail order run (RANGE frames)
    nex = torch.zeros((), dtype=torch.bool, device=dev)
    nfk_lo = nfk_hi = nfo = A_cnt = S_rcnt = u0
    nfv = {nm: u0 for nm, k, _, f in spec_calc
           if k == "lead" and not isinstance(f, tuple)}
    B_last = {nm: u0 for nm, k, _, _ in spec if k == "last_value"}
    S_tot = {nm: u0 for nm, k, _, _ in spec_calc if k in _TOTALS}
    S_run = {nm: u0 for nm, k, _, _ in spec_calc
             if k in ("range_sum", "range_min", "range_max")}
    rec_lead_cont, rec_rcont, rec_suffix, rec_rcnt = [], [], [], []
    rec_lead_val = {nm: [] for nm in nfv}
    rec_last = {nm: [] for nm in B_last}
    rec_tot = {nm: [] for nm in S_tot}
    rec_run = {nm: [] for nm in S_run}
    kind_col = {nm: (k, c) for nm, k, c, _ in spec_calc}

    def suffix_of(nm, h, s, cont_):
        """A shard's head aggregate h extended by the later shards' suffix
        s where its head partition (run) continues: sums add zero
        otherwise, as the JAX chain does."""
        k, c = kind_col[nm]
        if k in _SUMS:
            return fsum(h, torch.where(cont_, s, u0), k, c)
        return torch.where(cont_, _minmax(k, s, h, dtypes[c]), h)
    for e in range(n_dev - 1, -1, -1):
        nonempty = gv(e, "nv") > 0
        ncont = (nex & (gv(e, "lk_lo") == nfk_lo)
                 & (gv(e, "lk_hi") == nfk_hi))
        rec_lead_cont.append(ncont)
        if any_range:
            # run continuation: same partition and same order value
            ncont_r = ncont & (gv(e, "lo_") == nfo)
            rec_rcont.append(ncont_r)
            for nm in S_run:
                rec_run[nm].append(S_run[nm])
            rec_rcnt.append(S_rcnt)
        for nm in nfv:
            rec_lead_val[nm].append(nfv[nm])
        for nm in B_last:
            rec_last[nm].append(B_last[nm])
        rec_suffix.append(A_cnt)
        for nm in S_tot:
            rec_tot[nm].append(S_tot[nm])

        def upd(new, old):
            return torch.where(nonempty, new, old)
        # a one-partition shard: its head partition is its tail
        sn = (gv(e, "tps") == 0) & ncont
        for nm in B_last:
            B_last[nm] = upd(torch.where(sn, B_last[nm], gv(e, f"hlv:{nm}")),
                             B_last[nm])
        if has_cnt:
            A_cnt = upd(gv(e, "hcnt") + torch.where(sn, A_cnt, u0), A_cnt)
        for nm in S_tot:
            S_tot[nm] = upd(suffix_of(nm, gv(e, f"ha:{nm}"), S_tot[nm], sn),
                            S_tot[nm])
        if any_range:
            snr = (gv(e, "trs_zero") == 1) & ncont_r
            for nm in S_run:
                S_run[nm] = upd(suffix_of(nm, gv(e, f"hr:{nm}"), S_run[nm],
                                          snr), S_run[nm])
            if any_range_avg:
                S_rcnt = upd(gv(e, "hrc") + torch.where(snr, S_rcnt, u0),
                             S_rcnt)
            nfo = upd(gv(e, "fo"), nfo)
        nfk_lo = upd(gv(e, "fk_lo"), nfk_lo)
        nfk_hi = upd(gv(e, "fk_hi"), nfk_hi)
        for nm in nfv:
            nfv[nm] = upd(gv(e, f"fv:{nm}"), nfv[nm])
        nex = nex | nonempty

    def mine(lst):
        """The forward chain's record for each local shard, per row."""
        return st.rows(torch.stack(lst)[my])

    def mine_rev(lst):
        """The same for a record of the reverse chain (built from the
        last shard down)."""
        return st.rows(torch.stack(lst[::-1])[my])

    # ---- patch my boundary-partition rows ------------------------------
    cont, cont_o = mine(rec["cont"]), mine(rec["cont_o"])
    cc, cd, cr = mine(rec["C_cnt"]), mine(rec["C_dense"]), mine(rec["C_rank"])
    validrow = ~spad
    ploc = part_start - st.base[st.shard]
    rloc = run_start - st.base[st.shard]
    head = validrow & (ploc == 0) & cont
    ncont_m = mine_rev(rec_lead_cont)
    tail = validrow & (ploc == st.rows(tps)) & ncont_m
    hcc = torch.where(head, cc, 0)
    if any_range:
        tail_run = validrow & (rloc == st.rows(trs)) & mine_rev(rec_rcont)
    if has_cnt:
        suffix = torch.where(ncont_m, mine_rev(rec_suffix), 0)
        gcnt = (part_end - part_start + 1 + hcc
                + torch.where(tail, suffix, 0))
    rn0 = idx - part_start
    for name, kind, col, fill in spec_calc:
        o = out[name]
        if _haloed((name, kind, col, fill)) or kind in _MOVING:
            continue        # exact through the row halos
        if kind == "row_number":
            out[name] = _u32(_enc(o) + hcc)
        elif kind in ("rank", "percent_rank"):
            in_head_run = head & (rloc == 0) & cont_o
            if kind == "rank":
                out[name] = _u32(torch.where(in_head_run, cr, _enc(o) + hcc))
            else:
                grank0 = torch.where(in_head_run, cr - 1,
                                     run_start - part_start + hcc)
                den = torch.clamp(gcnt - 1, min=1).to(torch.float32)
                out[name] = torch.where(
                    validrow, grank0.to(torch.float32) / den, o)
        elif kind == "dense_rank":
            out[name] = _u32(_enc(o) + torch.where(
                head, cd - cont_o.to(torch.int64), 0))
        elif name in C_agg:
            # forward partition prefix on head rows, then the backward
            # suffix: the partition total's on tail rows, the order run's
            # on tail-run rows (RANGE)
            isum = int_sum(kind, col)
            e = _i64(o) if isum else _enc(o)
            cv = mine(rec_agg[name])
            if kind in _SUMS:
                if isum:
                    e = e + torch.where(head, cv, 0)
                else:
                    e = _enc(_dec(e, torch.float32) + torch.where(
                        head, _dec(cv, torch.float32), 0.0))
            else:
                e = torch.where(head, _minmax(kind, cv, e, dtypes[col]), e)
            back = (tail, mine_rev(rec_tot[name])) if name in S_tot else (
                (tail_run, mine_rev(rec_run[name])) if name in S_run
                else None)
            if back is not None:
                m, sv = back
                if kind in _SUMS:
                    if isum:
                        e = e + torch.where(m, sv, 0)
                    else:
                        e = _enc(_dec(e, torch.float32) + torch.where(
                            m, _dec(sv, torch.float32), 0.0))
                else:
                    e = torch.where(m, _minmax(kind, sv, e, dtypes[col]), e)
            out[name] = _pair(e) if isum else _dec(e, o.dtype)
        elif kind in ("lag", "lead", "first_value", "last_value"):
            # the chain's value where the neighbour shard supplies it (an
            # int64 carrier: torch.where takes no uint32 on the card)
            m, rec_ = {
                "lag": (first & cont & validrow, lambda: mine(rec_lag[name])),
                "lead": (validrow & (st.loc == st.rows(li)) & ncont_m,
                         lambda: mine_rev(rec_lead_val[name])),
                "first_value": (head, lambda: mine(rec_first[name])),
                "last_value": (tail, lambda: mine_rev(rec_last[name])),
            }[kind]
            out[name] = _dec(torch.where(m, rec_(), _enc(o)), o.dtype)
        elif kind == "moving_count":
            # index arithmetic over global partition offsets
            kk, bb = fill
            grn0 = rn0 + hcc
            back = grn0 + 1 if kk is None else torch.clamp(grn0 + 1, max=kk)
            v = back + torch.clamp(gcnt - 1 - grn0, max=bb)
            out[name] = _u32(torch.where(validrow, v, _enc(o)))
        elif kind == "ntile":
            grn0 = rn0 + hcc
            q, r = gcnt // fill, gcnt % fill
            big = r * (q + 1)
            hi_b = r + (grn0 - big) // torch.clamp(q, min=1)
            nt = torch.where(grn0 < big, grn0 // (q + 1), hi_b) + 1
            out[name] = _u32(torch.where(validrow, nt, _enc(o)))
        elif kind == "partition_count":
            out[name] = _u32(torch.where(validrow, gcnt, _enc(o)))

    # averages: the chain patched the numerator sums; divide by the global
    # denominator (the partition's rows for total_avg, the global row
    # number for running_avg, the rows through the order run's end for
    # range_avg)
    for name, kind, col, _ in spec:
        if kind not in _AVG:
            continue
        o = out[name]
        numf = (_pair_to_f32(_i64(o), dtypes[col] == torch.int32)
                if isinstance(o, U64) else o)
        if kind == "total_avg":
            den = gcnt
        elif kind == "range_avg":
            den = (t_idx - part_start + 1 + hcc
                   + torch.where(tail_run, mine_rev(rec_rcnt), 0))
        else:
            den = rn0 + 1 + hcc
        out[name] = numf / torch.clamp(den, min=1).to(torch.float32)

    def shaped(x):
        if isinstance(x, U64):
            return U64(x.lo.reshape(shards, L), x.hi.reshape(shards, L))
        return x.reshape(shards, L)

    return (U64(slo.reshape(shards, L), shi.reshape(shards, L)),
            widen(spos), {nm: shaped(out[nm]) for nm, _, _, _ in spec},
            n_v, overflow)


def plan_window_capacity(key: U64, order, mesh, samples_per_dev: int = 128,
                         backend: str = "radix") -> torch.Tensor:
    """Exact off-diagonal demand of the window exchange, (S,) int64, the
    same on every shard (its routing includes the order plane, so
    dsort.plan_sort_capacity does not apply)."""
    obits = None if order is None else sortable_u32(order)
    _, dest = _route(mesh, key.lo, key.hi, obits, mesh.n_dev,
                     samples_per_dev, backend)
    return offdiag_demand(mesh, dest, mesh.n_dev)


def auto_window_capacity(key: U64, order, mesh, samples_per_dev: int = 128,
                         slack: float = 1.05, backend: str = "radix") -> int:
    """plan_window_capacity read back and sized by pow2_capacity."""
    demand = int(plan_window_capacity(key, order, mesh, samples_per_dev,
                                      backend).max())
    return pow2_capacity(demand, slack)


def distributed_window(key: U64, funcs: dict, mesh, order=None,
                       values: dict | None = None,
                       samples_per_dev: int = 128,
                       capacity_factor: float = 2.0,
                       capacity: int | None = None,
                       backend: str = "radix"):
    """Window functions over sharded rows (module docstring).

    The spec language of ops.window.window. key is a U64 of (S, n_local)
    planes (mesh.shard of the global keys), order and values (S, n_local)
    uint32 / int32 / float32 columns. `capacity` as in distributed_sort.

    Returns (DistWindowResult, overflow): rows in global (key, order,
    input position) order as per-shard valid-prefix runs; scatter by `pos`
    to restore the input order. Integer columns equal ops.window.window on
    the same rows bit for bit.
    """
    spec = _canon_funcs(funcs)
    if order is None and any(k in ("rank", "dense_rank", "percent_rank")
                             for _, k, _, _ in spec):
        raise ValueError("rank/dense_rank/percent_rank require an "
                         "order column")
    if any(k in _MOVING and isinstance(f, tuple) and f[0] is None
           for _, k, _, f in spec):
        raise ValueError("UNBOUNDED PRECEDING with a FOLLOWING bound "
                         "is in-core only (distributed frames ride "
                         "bounded row halos)")
    if any(k in _RANGE and f != "unbounded" for _, k, _, f in spec):
        raise ValueError("bounded RANGE frames are in-core only (an "
                         "order-VALUE bound reaches back an unbounded "
                         "number of rows: no finite row halo covers it)")
    if order is None and any(k in _RANGE for _, k, _, _ in spec):
        raise ValueError("RANGE frames require an order column")
    values = values or {}
    needed = sorted({c for _, _, c, _ in spec if c is not None})
    for c in needed:
        if c not in values:
            raise ValueError(f"window spec references missing column {c!r}")
    n_dev = mesh.n_dev
    n_local = key.lo.shape[1]
    assert n_local * n_dev < (1 << 32), n_local * n_dev
    if capacity is None:
        capacity = int(np.ceil(capacity_factor * n_local / n_dev))
    capacity = max(capacity, 16)
    assert n_dev * max(capacity, n_local) < (1 << 31), (n_dev, capacity)
    skey, pos, cols, valid, overflow = _dwindow_shard(
        mesh, key.lo, key.hi, None if order is None else sortable_u32(order),
        {c: values[c] for c in needed}, n_dev=n_dev,
        samples_per_dev=samples_per_dev, capacity=capacity, spec=spec,
        backend=backend)
    return DistWindowResult(skey, pos, cols, valid), overflow


def distributed_window_numpy(keys: np.ndarray, funcs: dict, mesh,
                             order: np.ndarray | None = None,
                             values: dict | None = None, **kw):
    """Host wrapper for tests and benches: shard the inputs, run, scatter
    the sorted runs back to input order by `pos`. capacity_factor="auto"
    plans the exchange demand first (plan_window_capacity). Under a
    GroupMesh every rank passes the global input and gets every row."""
    key = shard_u64(keys, mesh)
    t_order = None if order is None else shard_column(order, mesh)
    t_vals = {nm: shard_column(v, mesh) for nm, v in (values or {}).items()}
    if kw.get("capacity_factor") == "auto":
        kw = dict(kw)
        del kw["capacity_factor"]
        if mesh.n_dev > 1:
            kw["capacity"] = auto_window_capacity(
                key, t_order, mesh,
                samples_per_dev=kw.get("samples_per_dev", 128),
                backend=kw.get("backend", "radix"))
    res, overflow = distributed_window(key, funcs, mesh, order=t_order,
                                       values=t_vals, **kw)
    if int(overflow.max()):
        raise RuntimeError("exchange capacity overflow; raise "
                           "capacity_factor")
    n = len(keys)
    valid = mesh.collect(res.valid).cpu().numpy()
    pos = mesh.collect(res.pos).cpu().numpy()
    out = {}
    for name, col in res.cols.items():
        if isinstance(col, U64):
            flat = U64(mesh.collect(col.lo), mesh.collect(col.hi)).to_numpy()
        else:
            flat = column_to_numpy(from_plane(mesh.collect(plane(col)),
                                              col.dtype))
        o = np.zeros(n, flat.dtype)
        for d, v in enumerate(valid):
            o[pos[d, :int(v)]] = flat[d, :int(v)]
        out[name] = o
    return out
