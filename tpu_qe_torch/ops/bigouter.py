"""Out-of-core LEFT / FULL OUTER join: the port of tpu_qe/ops/bigouter.py.

The bigjoin bucket recipe (ops/bigjoin.py) with ``join_outer_padded`` as
the joiner: key-range buckets cut both sorted sides by the same
splitters, so every copy of a key, left and right, lands in one bucket,
and each bucket's left verdicts (matched / NULL right) and right verdicts
(right-only) are exact locally. The port slices each bucket exactly where
the reference pads it to static capacities; the per-bucket checks are the
reference's all the same.

Data model (generated on the device; every verdict decidable per row):

  right row i:  key = (lo = i << 1, hi = fmix32(i ^ seed)): lo even, the
                keys injective, so the duplicate-right-key order of
                join_outer_padded (ROADMAP Queue C) cannot show here
  left row j:   even j -> the key of right row 2 * ((j >> 1) mod (n_r /
                2)), a match on an even right index; odd j -> a key with
                the low bit set, a miss
  joined value  rv = fmix32(key.lo ^ key.hi ^ C)

With (n_l + 1) // 2 >= n_r // 2 every even right index is hit: left row j
matches iff j is even, right row i is right-only iff i is odd, and every
left row takes exactly one output slot. Checked per bucket on the device:
match flags against lidx parity, joined values against f(key), zeroed
right columns on unmatched slots (the NULL convention), right-only rows
against ridx parity and the key's closed form, exact section counts.

Every sort is ``sort_planes`` (the B1-B3 radix kernels on the card).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from tpu_qe_torch.bits import U64, narrow, widen
from tpu_qe_torch.config import resolve_device
from tpu_qe_torch.hashing import murmur_fmix32, murmur_fmix32_numpy
from tpu_qe_torch.ops.bigagg import _const
from tpu_qe_torch.ops.bigjoin import (_plan_buckets, _seg_plan, _segment,
                                      _sorted_side)
from tpu_qe_torch.ops.join import join_outer_padded
from tpu_qe_torch.sort.bigsort import _build_seconds, _fence
from tpu_qe_torch.table import Table
from tpu_qe_torch.utils.checkpoint import RunState as _RunState
from tpu_qe_torch.utils.profiling import span

_VAL_C = 0x07E12B5  # outer-join value salt


def _rkey_of_index(i: torch.Tensor, seed: int) -> U64:
    """Injective right key of right row i: lo = i << 1, hi = fmix(i)."""
    return U64(narrow(widen(i) << 1), murmur_fmix32(i ^ _const(seed)))


def _rval_of_key(key: U64) -> torch.Tensor:
    return murmur_fmix32(key.lo ^ key.hi ^ _VAL_C)


def _lkey_of_index(j: torch.Tensor, n_r: int, seed: int) -> U64:
    """Even j -> the key of right row 2 * ((j >> 1) mod (n_r / 2)); odd
    j -> a miss key with the low bit set (right lo is always even)."""
    i = narrow(((widen(j) >> 1) % (n_r >> 1)) << 1)
    hit = _rkey_of_index(i, seed)
    even = (j & 1) == 0
    miss_lo = murmur_fmix32(j ^ _const(seed + 0x5A17)) | 1
    miss_hi = murmur_fmix32(j ^ _const(seed + 0xB055))
    return U64(torch.where(even, hit.lo, miss_lo),
               torch.where(even, hit.hi, miss_hi))


def rkeys_numpy(n_r: int, seed: int = 7) -> np.ndarray:
    """Host twin of the right-key generator (oracle tests)."""
    i = np.arange(n_r, dtype=np.uint32)
    lo = (i << np.uint32(1)).astype(np.uint64)
    hi = murmur_fmix32_numpy(i ^ np.uint32(seed)).astype(np.uint64)
    return lo | (hi << np.uint64(32))


def lkeys_numpy(n_l: int, n_r: int, seed: int = 7) -> np.ndarray:
    """Host twin of the left-key generator (oracle tests)."""
    j = np.arange(n_l, dtype=np.uint32)
    i = ((j >> np.uint32(1)) % np.uint32(n_r >> 1)) << np.uint32(1)
    hit_lo = (i << np.uint32(1)).astype(np.uint64)
    hit_hi = murmur_fmix32_numpy(i ^ np.uint32(seed)).astype(np.uint64)
    hit = hit_lo | (hit_hi << np.uint64(32))
    m_lo = (murmur_fmix32_numpy(j ^ np.uint32(seed + 0x5A17))
            | np.uint32(1)).astype(np.uint64)
    m_hi = murmur_fmix32_numpy(j ^ np.uint32(seed + 0xB055)).astype(
        np.uint64)
    miss = m_lo | (m_hi << np.uint64(32))
    return np.where(j % 2 == 0, hit, miss)


def rval_numpy(key: np.ndarray) -> np.ndarray:
    lo = (key & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (key >> np.uint64(32)).astype(np.uint32)
    return murmur_fmix32_numpy(lo ^ hi ^ np.uint32(_VAL_C))


def _make_sorted_side(n: int, n_r: int, seed: int, side: str, device):
    """One side generated and sorted by key, (lo, hi, idx), both with the
    index (left: output identity; right: the right-only closed form)."""
    key_of = ((lambda i: _rkey_of_index(i, seed)) if side == "right"
              else (lambda i: _lkey_of_index(i, n_r, seed)))
    return _sorted_side(n, key_of, True, device)


def _outer_bucket(st_l, sz_l, st_r, sz_r, llo, lhi, lidx, rlo, rhi, ridx,
                  full: bool, seed: int, collect: bool):
    """Phase C for one bucket: the 11 scalars as one int64 tensor and,
    with collect, the stream (klo, khi, lidx, matched, rv, slot valid[,
    right-only ridx, right-only valid]). An empty side joins one invalid
    row, as the reference's padding would."""
    dev = llo.device
    s_llo = _segment(llo, st_l, sz_l, -1)
    s_lhi = _segment(lhi, st_l, sz_l, -1)
    s_lidx = _segment(lidx, st_l, sz_l, 0)
    l_valid = torch.full(s_llo.shape, sz_l > 0, dtype=torch.bool,
                         device=dev)
    s_rlo = _segment(rlo, st_r, sz_r, -1)
    s_rhi = _segment(rhi, st_r, sz_r, -1)
    s_ridx = _segment(ridx, st_r, sz_r, 0)
    r_valid = torch.full(s_rlo.shape, sz_r > 0, dtype=torch.bool,
                         device=dev)
    rkey = U64(s_rlo, s_rhi)
    rv = torch.where(r_valid, _rval_of_key(rkey), 0)
    # the left key rides as ordinary left columns: output slots are the
    # valid left rows, compacted
    cap_l = s_llo.shape[0]
    res = join_outer_padded(
        Table({"lidx": s_lidx, "klo": s_llo, "khi": s_lhi}),
        Table({"ridx": s_ridx, "rv": rv}),
        U64(s_llo, s_lhi), rkey, l_valid, r_valid, out_budget=cap_l,
        full=full)
    out, matched = res.table, res.matched
    slot_valid = torch.arange(cap_l, device=dev) < res.num_out
    # every valid slot's verdict is the lidx-parity closed form; matched
    # slots carry rv == f(key), unmatched slots zeroed right columns
    expect = (out["lidx"] & 1) == 0
    want_rv = _rval_of_key(U64(out["klo"], out["khi"]))
    m_ok = (~slot_valid | (matched == expect)).all()
    v_ok = torch.where(matched, out["rv"] == want_rv,
                       (out["rv"] == 0) & (out["ridx"] == 0)).all()
    n_matched = (matched & slot_valid).sum()
    n_even = (l_valid & ((s_lidx & 1) == 0)).sum()
    z = torch.zeros((), dtype=torch.int64, device=dev)
    scalars = [m_ok.to(torch.int64), v_ok.to(torch.int64), res.overflow,
               res.num_out, n_matched, n_even, z + sz_l, z + sz_r]
    if full:
        ro, n_ro = res.right_only, res.num_right_only
        ro_valid = torch.arange(s_rlo.shape[0], device=dev) < n_ro
        gk = _rkey_of_index(ro["ridx"], seed)
        ro_ok = (~ro_valid | (
            ((ro["ridx"] & 1) == 1)
            & (ro["_key"].lo == gk.lo) & (ro["_key"].hi == gk.hi)
            & (ro["rv"] == _rval_of_key(ro["_key"])))).all()
        n_odd = (r_valid & ((s_ridx & 1) == 1)).sum()
        scalars += [ro_ok.to(torch.int64), n_ro, n_odd]
    else:
        scalars += [z + 1, z, z]
    scalars = torch.stack(scalars)
    if not collect:
        return scalars, ()
    stream = (out["klo"], out["khi"], out["lidx"], matched & slot_valid,
              out["rv"], slot_valid)
    if full:
        stream += (res.right_only["ridx"], ro_valid)
    return scalars, stream


@dataclasses.dataclass(frozen=True)
class BigOuterResult:
    n_l: int
    n_r: int
    full: bool
    seconds: float
    rows_per_s: float          # left rows per second through the join
    matched: int               # exact matched left rows
    num_out: int               # exact left-expanded output rows
    right_only: int            # exact right-only rows (FULL)
    match_ok: bool
    val_ok: bool
    ro_ok: bool
    count_ok: bool
    phase_a_s: float
    phase_c_s: float
    compile_s: float = 0.0

    @property
    def all_ok(self) -> bool:
        return (self.match_ok and self.val_ok and self.ro_ok
                and self.count_ok)


class _OuterState(_RunState):
    """Checkpoint state: the bucket plan (both sides) and 11 scalars a
    bucket; the sorted sides regenerate (the big sort's argument)."""

    N_SCALARS = 11

    @staticmethod
    def _path(directory: str) -> str:
        return os.path.join(directory, "bigouter_state.npz")


def join_big_outer(n_l: int, n_r: int, how: str = "full",
                   n_buckets: int | None = None, seed: int = 7,
                   samples_per_side: int = 8192, verbose: bool = False,
                   collect: bool = False,
                   checkpoint_dir: str | None = None,
                   device: str | torch.device = "cuda"):
    """Out-of-core LEFT / FULL OUTER join of n_l x n_r generated rows,
    every bucket's left and right verdicts verified on the device (module
    docstring); on the card unless `device` names another.

    how="left" skips the right-only probe. collect=True also returns the
    valid left slots dict(key, lidx, matched, value[, ro_ridx]) in global
    key order (oracle tests). checkpoint_dir: the bucket plan and each
    bucket's scalars persist (`bigouter_state.npz`), as in join_big.
    """
    assert how in ("left", "full"), how
    assert n_l < (1 << 32) and n_r < (1 << 31)  # lo = i<<1 injective
    assert n_r >= 2 and n_r % 2 == 0, \
        "data model splits right rows by index parity (n_r >= 2, even)"
    assert (n_l + 1) // 2 >= n_r // 2, \
        "coverage: every even right index must be hit"
    dev = resolve_device(device)
    full = how == "full"
    if n_buckets is None:
        n_buckets = max(2, int(np.ceil((n_l + n_r) / (1 << 26))))
    meta = np.asarray([n_l, n_r, int(full), n_buckets, seed,
                       samples_per_side, 0x0073], np.int64)
    state = (_OuterState.load(checkpoint_dir, meta)
             if checkpoint_dir is not None else None)
    compile_s = _build_seconds(dev)

    t0 = _fence(dev)
    with span("bigouter phase A: side sorts"):
        llo, lhi, lidx = _make_sorted_side(n_l, n_r, seed, "left", dev)
        rlo, rhi, ridx = _make_sorted_side(n_r, n_r, seed, "right", dev)
    t_a = _fence(dev) - t0

    if state is not None:
        bl, br = state.bounds[0], state.bounds[1]
        t_b = 0.0
    else:
        t0 = _fence(dev)
        bl, br = (b.cpu().numpy().astype(np.int64) for b in _plan_buckets(
            llo, lhi, rlo, rhi, n_buckets, samples_per_side))
        t_b = _fence(dev) - t0
        if checkpoint_dir is not None:
            state = _OuterState.fresh(checkpoint_dir, meta,
                                      np.stack([bl, br]), n_buckets)
    st_l, sz_l = _seg_plan(bl, n_l)
    st_r, sz_r = _seg_plan(br, n_r)
    if verbose:
        print(f"bigouter[{how}]: {n_buckets} buckets, left rows per bucket "
              f"up to {int(sz_l.max())}, right up to {int(sz_r.max())}")

    t1 = _fence(dev)
    skip = set()
    if state is not None and not collect:
        skip = {b for b in range(n_buckets) if state.done[b]}
        if verbose and skip:
            print(f"bigouter: resuming — {len(skip)}/{n_buckets} buckets "
                  "already joined")
    collected = []
    matched = num_out = n_ro = rows_l = rows_r = expected = ovf = 0
    m_ok = v_ok = ro_ok = True
    with span("bigouter phase C: bucket joins"):
        for b in range(n_buckets):
            if b in skip:
                vals = [int(v) for v in state.scalars[b]]
            else:
                out, stream = _outer_bucket(
                    int(st_l[b]), int(sz_l[b]), int(st_r[b]), int(sz_r[b]),
                    llo, lhi, lidx, rlo, rhi, ridx, full, seed, collect)
                if collect:
                    s_llo, s_lhi, o_lidx, o_m, o_rv, o_v = (
                        x.cpu().numpy() for x in stream[:6])
                    keep = o_v
                    k64 = (s_lhi.view(np.uint32).astype(np.uint64)
                           << np.uint64(32)) \
                        | s_llo.view(np.uint32).astype(np.uint64)
                    ent = dict(key=k64[keep],
                               lidx=o_lidx.view(np.uint32)[keep],
                               matched=o_m[keep],
                               value=o_rv.view(np.uint32)[keep])
                    if full:
                        ro_i, ro_v = (x.cpu().numpy() for x in stream[6:])
                        ent["ro_ridx"] = ro_i.view(np.uint32)[ro_v]
                    collected.append(ent)
                del stream
                vals = out.tolist()
                if state is not None:
                    state.record(b, vals)
            (mo, vo, ov, no, nm, ne, nl_b, nr_b, roo, nro, nodd) = vals
            m_ok &= bool(mo)
            v_ok &= bool(vo)
            ro_ok &= bool(roo) and (nro == nodd)
            ovf += ov
            num_out += no
            matched += nm
            expected += ne
            n_ro += nro
            rows_l += nl_b
            rows_r += nr_b
            if verbose:
                print(f"  bucket {b}: {nl_b}+{nr_b} rows, {nm} matched, "
                      f"{nro} right-only ok={bool(mo) and bool(vo)}")
    t_c = _fence(dev) - t1

    count_ok = (ovf == 0 and rows_l == n_l and rows_r == n_r
                and num_out == n_l
                and matched == expected == (n_l + 1) // 2
                and (not full or n_ro == n_r - n_r // 2))
    dt = t_a + t_b + t_c
    res = BigOuterResult(
        n_l=n_l, n_r=n_r, full=full, seconds=dt, rows_per_s=n_l / dt,
        matched=matched, num_out=num_out, right_only=n_ro,
        match_ok=m_ok, val_ok=v_ok, ro_ok=ro_ok, count_ok=count_ok,
        phase_a_s=t_a, phase_c_s=t_c, compile_s=compile_s)
    if collect:
        out = {k: np.concatenate([c[k] for c in collected])
               for k in ("key", "lidx", "matched", "value")}
        if full:
            out["ro_ridx"] = np.concatenate([c["ro_ridx"]
                                             for c in collected])
        return res, out
    return res
