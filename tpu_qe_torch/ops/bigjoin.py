"""Out-of-core FK join of sides larger than one join program: the port of
tpu_qe/ops/bigjoin.py.

``join_fk_scan`` sorts the combined (right + left) stream and caps it at
2^30 rows; this module lifts the cap with the big sort's bucket recipe:

  phase A   generate each side on the device and sort it by key (left with
            its row index as payload); both stay resident;
  phase B   splitters at the B-quantiles of strided samples of both
            sorted sides, and each side's bucket boundaries by
            ``searchsorted_u64(side="left")``: exact, so every copy of a
            key lands in one bucket on both sides. The plan is the
            reference's to the bit, so its checkpoint loads in either
            package;
  phase C   per bucket, in key order: each side's segment sliced exactly
            (the reference pads to static capacities with masks), joined
            with ``join_fk_scan`` and verified on the device against the
            generator's closed form: left row j matches iff j is even, and
            every joined value is a hash of the key.

Data model (generated on the device): right keys are index hashes with the
low bit cleared; an even left row takes the key of right row (j *
2654435761 mod n_r), a wrapping u32 product; an odd left row a key with
the low bit set, which no right key has. Duplicate right keys (hash
collisions) carry the same value, a function of the key, so any FK winner
verifies.

Every sort is ``sort_planes`` (the B1-B3 radix kernels on the card).
Phases are fenced with torch.cuda.synchronize(); `compile_s` is the time
the CUDA kernels took to build at first use (0 when built, and on the
CPU).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from tpu_qe_torch.bits import U64, mul_lo32, narrow, widen
from tpu_qe_torch.config import resolve_device
from tpu_qe_torch.hashing import keygen_hash, murmur_fmix32
from tpu_qe_torch.ops.bigagg import _const
from tpu_qe_torch.ops.join import join_fk_scan, searchsorted_u64
from tpu_qe_torch.sort.bigsort import CHUNK, _build_seconds, _fence
from tpu_qe_torch.sort.planes import sort_planes
from tpu_qe_torch.table import Table
from tpu_qe_torch.utils.checkpoint import RunState as _RunState
from tpu_qe_torch.utils.profiling import span

_VAL_C = _const(0xABCD1234)


def _rkey_of_index(i: torch.Tensor, seed: int) -> U64:
    """Right key of right row i (int32 plane): the index hash with the low
    bit cleared."""
    k = keygen_hash(i, seed)
    return U64(k.lo & -2, k.hi)


def _rval_of_key(key: U64) -> torch.Tensor:
    """Joined value as a closed form of the key (verifiable anywhere)."""
    return murmur_fmix32(key.lo ^ key.hi ^ _VAL_C)


def _lkey_of_index(j: torch.Tensor, n_r: int, seed: int) -> U64:
    """Left key of left row j (int32 plane): even j -> the key of right
    row (j * 2654435761 mod 2^32) mod n_r (a match); odd j -> a key with
    the low bit set (a miss: every right key's is clear)."""
    i = narrow(mul_lo32(widen(j), 2654435761) % n_r)
    hit = _rkey_of_index(i, seed)
    missk = keygen_hash(j, seed + 1)
    even = (j & 1) == 0
    return U64(torch.where(even, hit.lo, missk.lo | 1),
               torch.where(even, hit.hi, missk.hi))


def _sorted_side(n: int, key_of_index, with_index: bool, device):
    """Rows 0 .. n-1 generated CHUNK rows at a time (key_of_index(i) of an
    int32 index plane) and sorted by key: (lo, hi[, idx]). The reference
    sorts by (hi, lo, idx) with an unstable sort; the stable sort by (hi,
    lo) of rows made in index order gives the same order, since rows of
    equal keys keep ascending index order."""
    lo = torch.empty(n, dtype=torch.int32, device=device)
    hi = torch.empty_like(lo)
    idx = torch.empty_like(lo) if with_index else None
    for a in range(0, n, CHUNK):
        b = min(a + CHUNK, n)
        i = narrow(torch.arange(a, b, device=device))
        key = key_of_index(i)
        lo[a:b], hi[a:b] = key.lo, key.hi
        if with_index:
            idx[a:b] = i
    planes = [hi, lo] + ([idx] if with_index else [])
    del lo, hi, idx
    shi, slo, *rest = sort_planes(planes, 2)
    return (slo, shi, *rest)


def _make_sorted_side(n: int, n_r: int, seed: int, side: str, device):
    """One side generated and sorted by key. Right: (lo, hi); it needs no
    payload, the joined value is a function of the key. Left: (lo, hi,
    idx)."""
    if side == "right":
        return _sorted_side(n, lambda i: _rkey_of_index(i, seed), False,
                            device)
    return _sorted_side(n, lambda i: _lkey_of_index(i, n_r, seed), True,
                        device)


def _plan_buckets(llo, lhi, rlo, rhi, n_buckets: int, per_side: int):
    """Splitters at the quantiles of both sides' strided samples, and each
    side's (B-1,) int64 bucket boundaries."""
    s_lo, s_hi = [], []
    for lo, hi in ((llo, lhi), (rlo, rhi)):
        n = lo.shape[0]
        stride = max(n // per_side, 1)
        sel = torch.arange(per_side, device=lo.device) * stride % n
        s_lo.append(lo[sel])
        s_hi.append(hi[sel])
    sh, sl = sort_planes([torch.cat(s_hi), torch.cat(s_lo)], 2)
    total = sl.shape[0]
    q = torch.arange(1, n_buckets, device=sl.device) * total // n_buckets
    sp = U64(sl[q], sh[q])
    bl = searchsorted_u64(U64(llo, lhi), sp, side="left")
    br = searchsorted_u64(U64(rlo, rhi), sp, side="left")
    return bl, br


def _verify_construction(s_lidx, l_valid, s_llo, s_lhi, out_rv, matched):
    """One bucket's join against the generator's closed form: matches are
    exactly the even left indices and every joined value equals f(key).
    Returns (match_ok, val_ok, n_matched, n_even) as 0-d int64 tensors."""
    expect = (s_lidx & 1) == 0
    match_ok = (~l_valid | (matched == expect)).all()
    want_rv = _rval_of_key(U64(s_llo, s_lhi))
    val_ok = (~matched | (out_rv == want_rv)).all()
    n_matched = (matched & l_valid).sum()
    n_even = (l_valid & expect).sum()
    return (match_ok.to(torch.int64), val_ok.to(torch.int64), n_matched,
            n_even)


def _segment(col: torch.Tensor, start: int, size: int, fill: int):
    """Rows [start, start + size) of a sorted side; an empty segment is
    one `fill` row, masked invalid by the caller."""
    if size:
        return col[start:start + size]
    return torch.full((1,), fill, dtype=col.dtype, device=col.device)


def _join_bucket(st_l, sz_l, st_r, sz_r, llo, lhi, lidx, rlo, rhi):
    """Phase C for one bucket: (scalars as one int64 tensor, the joined
    stream). The stream's slots are the bucket's key-sorted left rows:
    key planes, lidx, value, matched and valid (int32 flags)."""
    dev = llo.device
    s_llo, s_lhi = llo[st_l:st_l + sz_l], lhi[st_l:st_l + sz_l]
    s_lidx = lidx[st_l:st_l + sz_l]
    l_valid = torch.ones(sz_l, dtype=torch.bool, device=dev)
    if sz_l == 0:
        rv = torch.zeros(0, dtype=torch.int32, device=dev)
        matched = torch.zeros(0, dtype=torch.bool, device=dev)
    else:
        # a right side with no row in this bucket joins one invalid row
        r_valid = None if sz_r else torch.zeros(1, dtype=torch.bool,
                                                device=dev)
        rkey = U64(_segment(rlo, st_r, sz_r, -1),
                   _segment(rhi, st_r, sz_r, -1))
        out, matched = join_fk_scan(
            Table({"lidx": s_lidx}), Table({"rv": _rval_of_key(rkey)}),
            U64(s_llo, s_lhi), rkey, r_valid=r_valid)
        rv = out["rv"]
    z = torch.zeros((), dtype=torch.int64, device=dev)
    scalars = torch.stack(list(_verify_construction(
        s_lidx, l_valid, s_llo, s_lhi, rv, matched)) + [z + sz_l, z + sz_r])
    flags = matched.to(torch.int32)
    return scalars, (s_llo, s_lhi, s_lidx, rv, flags,
                     l_valid.to(torch.int32))


@dataclasses.dataclass(frozen=True)
class BigJoinResult:
    n_l: int
    n_r: int
    seconds: float
    rows_per_s: float          # left rows joined per second
    matched: int               # exact global match count
    match_ok: bool             # every flag equals the construction oracle
    val_ok: bool               # every joined value equals f(key)
    count_ok: bool             # counts: matched == expected, rows == n
    phase_a_s: float
    phase_c_s: float
    compile_s: float = 0.0

    @property
    def all_ok(self) -> bool:
        return self.match_ok and self.val_ok and self.count_ok


class _JoinState(_RunState):
    """Checkpoint state of join_big: the bucket plan (both sides'
    boundaries) and six scalars per bucket; the sorted sides regenerate
    (the big sort's argument, utils/checkpoint.RunState)."""

    N_SCALARS = 6  # match_ok, val_ok, n_matched, n_even, rows_l, rows_r

    @staticmethod
    def _path(directory: str) -> str:
        return os.path.join(directory, "bigjoin_state.npz")


def _seg_plan(bounds: np.ndarray, n: int):
    starts = np.concatenate([[0], bounds]).astype(np.int64)
    ends = np.concatenate([bounds, [n]]).astype(np.int64)
    return starts, ends - starts


def join_big(n_l: int, n_r: int, n_buckets: int | None = None,
             seed: int = 7, samples_per_side: int = 8192,
             verbose: bool = False, consume=None, collect: bool = False,
             checkpoint_dir: str | None = None,
             device: str | torch.device = "cuda"):
    """Out-of-core FK join of n_l x n_r rows generated on the device, every
    bucket's matches and values verified there (module docstring); on the
    card unless `device` names another.

    consume(b, bucket): called per bucket in global key order with device
    tensors: key (U64 left keys, sorted), lidx (the left row index), value
    (the joined right value, 0 where unmatched), matched and valid (int32
    flags; the port slices buckets exactly, so every slot is valid).
    collect=True also returns dict(key, lidx, value, matched) of every
    left row in global key order (small-n tests). checkpoint_dir: the
    bucket plan and each bucket's scalars persist
    (`bigjoin_state.npz`); a restarted run regenerates the sorted sides,
    loads the plan and skips finished buckets unless consume / collect
    asks for their streams again.
    """
    assert n_l < (1 << 32) and n_r < (1 << 32)
    dev = resolve_device(device)
    if n_buckets is None:
        n_buckets = max(2, int(np.ceil((n_l + n_r) / (1 << 26))))
    meta = np.asarray([n_l, n_r, n_buckets, seed, samples_per_side],
                      np.int64)
    state = (_JoinState.load(checkpoint_dir, meta)
             if checkpoint_dir is not None else None)
    compile_s = _build_seconds(dev)

    t0 = _fence(dev)
    with span("bigjoin phase A: side sorts"):
        llo, lhi, lidx = _make_sorted_side(n_l, n_r, seed, "left", dev)
        rlo, rhi = _make_sorted_side(n_r, n_r, seed, "right", dev)
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
            state = _JoinState.fresh(checkpoint_dir, meta,
                                     np.stack([bl, br]), n_buckets)
    st_l, sz_l = _seg_plan(bl, n_l)
    st_r, sz_r = _seg_plan(br, n_r)
    if verbose:
        print(f"bigjoin: {n_buckets} buckets, left rows per bucket up to "
              f"{int(sz_l.max())}, right up to {int(sz_r.max())}")

    emit = consume is not None or collect
    t1 = _fence(dev)
    skip = set()
    if state is not None and not emit:
        skip = {b for b in range(n_buckets) if state.done[b]}
        if verbose and skip:
            print(f"bigjoin: resuming — {len(skip)}/{n_buckets} buckets "
                  "already joined")
    matched = expected = rows_l = rows_r = 0
    m_ok = v_ok = True
    collected = []
    with span("bigjoin phase C: bucket joins"):
        for b in range(n_buckets):
            if b in skip:
                vals = [int(v) for v in state.scalars[b]]
            else:
                out, stream = _join_bucket(
                    int(st_l[b]), int(sz_l[b]), int(st_r[b]), int(sz_r[b]),
                    llo, lhi, lidx, rlo, rhi)
                if consume is not None:
                    s_llo, s_lhi, s_lidx, s_val, s_m, s_v = stream
                    consume(b, dict(key=U64(s_llo, s_lhi), lidx=s_lidx,
                                    value=s_val, matched=s_m, valid=s_v))
                if collect:
                    s_llo, s_lhi, s_lidx, s_val, s_m, _ = (
                        x.cpu().numpy() for x in stream)
                    collected.append((
                        (s_lhi.view(np.uint32).astype(np.uint64)
                         << np.uint64(32))
                        | s_llo.view(np.uint32).astype(np.uint64),
                        s_lidx.view(np.uint32), s_val.view(np.uint32),
                        s_m.astype(bool)))
                del stream
                vals = out.tolist()
                if state is not None:
                    state.record(b, vals)
            mo, vo, nm, ne, nl_b, nr_b = vals
            m_ok &= bool(mo)
            v_ok &= bool(vo)
            matched += nm
            expected += ne
            rows_l += nl_b
            rows_r += nr_b
            if verbose:
                print(f"  bucket {b}: {nl_b}+{nr_b} rows, {nm} matched "
                      f"ok={bool(mo) and bool(vo)}")
    t_c = _fence(dev) - t1

    # exact global counts: every left row in exactly one bucket; the
    # match set is exactly the even left indices
    count_ok = (rows_l == n_l and rows_r == n_r
                and matched == expected == (n_l + 1) // 2)
    dt = t_a + t_b + t_c
    res = BigJoinResult(
        n_l=n_l, n_r=n_r, seconds=dt, rows_per_s=n_l / dt,
        matched=matched, match_ok=m_ok, val_ok=v_ok, count_ok=count_ok,
        phase_a_s=t_a, phase_c_s=t_c, compile_s=compile_s)
    if collect:
        return res, {
            "key": np.concatenate([c[0] for c in collected]),
            "lidx": np.concatenate([c[1] for c in collected]),
            "value": np.concatenate([c[2] for c in collected]),
            "matched": np.concatenate([c[3] for c in collected]),
        }
    return res
