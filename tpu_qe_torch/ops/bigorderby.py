"""Out-of-core multi-column ORDER BY: the external sample sort over
transformed key planes; the port of tpu_qe/ops/bigorderby.py.

ops/orderby.py orders rows by mixed-type, mixed-direction key lists
through order-preserving u32 planes (DESC = inverted bits, a bijection, so
lexicographic order on the transformed planes is the requested order).
The out-of-core sort's phases then give multi-column DESC / ASC order:

  phase A   per run: generate the table chunk on the device and sort it
            by (transformed planes..., row index);
  phase B   composite splitters: strided samples of every run's (planes...,
            index) order, global bucket quantiles, then each run's segment
            boundaries by the lexicographic search of ops/bigwindow.py, so
            runs of one key split across buckets by the index plane;
  phase C   per bucket: one segment per run, one sort of the
            concatenation, verification on the device, and a carry of
            K + 3 scalars (the bucket's last composite row and an exact u64
            running index sum) chained as a device tensor: the whole phase
            queues with no read-back.

Verified on the device per bucket: lexicographic order including the
index tie-break, every row's key planes re-derived from its index (each
output row is a real input row), exact counts, the order across the
bucket boundary against the carry, and a permutation certificate: the sum
of indices over all buckets must be n(n-1)/2.

Data model (with a numpy twin for oracle tests): column a is a u64 with
`a_card` distinct values (hash-derived, hi a bijection of lo), column b a
full-range signed i32, payload a hash of the index; order_by_big orders by
(a DESC, b ASC), the mixed-direction shape of the in-core operator.

Differences from the reference, none of which changes a result:
- Every sort is ``sort_planes`` (B1-B3 on the card) and stable. The
  reference sorts runs and buckets by (~a_hi, ~a_lo, b ^ 2^31, index)
  unstably; the port sorts stably by the three transformed planes, 12 LSD
  passes where the index key would add 4. A run is generated in index
  order, so its rows of equal planes stand in ascending index order; a
  bucket concatenates the runs' segments in run order, and run r holds
  indices [r * run_size, (r + 1) * run_size), so the same holds there and
  the stable sort gives the index key's order.
- Segments are sliced exactly: no padding to a static capacity and no
  sentinel rows.
- The carry and checks are int64 tensors of u32 values, and the index sum
  an int64 (exact below 2^63), compared unsigned throughout.

Phases are fenced with torch.cuda.synchronize(). `compile_s` is the time
the CUDA kernels took to build at first use (0 when they were built, and
on the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_qe_torch.bits import SIGN_BIT, U32_MASK, narrow, widen
from tpu_qe_torch.config import resolve_device
from tpu_qe_torch.hashing import murmur_fmix32_numpy
from tpu_qe_torch.ops.bigwindow import _mix, _searchsorted_multi, _u64_bits
from tpu_qe_torch.sort.bigsort import _build_seconds, _fence
from tpu_qe_torch.sort.driver import signed_key
from tpu_qe_torch.sort.planes import sort_planes
from tpu_qe_torch.utils.profiling import span

_A_SALT = 0x0A0A0A0A
_B_SALT = 0x1B1B1B1B
N_PLANES = 3   # transformed: ~a_hi, ~a_lo, sortable(b)
N_COLS = N_PLANES + 2  # + index + payload
N_CARRY = 6   # last (t1, t2, t3, idx) + running index sum (lo, hi)
N_CHECK = 4   # s_ok, h_ok, b_ok, cnt


def _cols_of(idx: torch.Tensor, a_card: int, seed: int):
    """Transformed key planes (a DESC as inverted bits, b ASC as the
    sign-flipped i32 bits) and the payload of rows idx (int32 planes)."""
    x = widen(idx)
    alo = _mix(x, seed ^ _A_SALT) % a_card
    ahi = _mix(alo, 0x9E3779B9)
    b = narrow(_mix(x, seed ^ _B_SALT))
    pay = narrow(_mix(x, seed ^ 0x2C2C2C2C))
    return ~narrow(ahi), ~narrow(alo), b ^ SIGN_BIT, pay


def rows_numpy(idx: np.ndarray, a_card: int, seed: int = 7):
    """Host twin: (a u64, b i32, pay u32) in original (untransformed)
    values; oracle tests sort these with numpy."""
    idx = idx.astype(np.uint32)
    alo = murmur_fmix32_numpy(
        idx ^ np.uint32((seed ^ _A_SALT) & 0xFFFFFFFF)) % np.uint32(a_card)
    ahi = murmur_fmix32_numpy(alo ^ np.uint32(0x9E3779B9))
    a = alo.astype(np.uint64) | (ahi.astype(np.uint64) << np.uint64(32))
    b = murmur_fmix32_numpy(
        idx ^ np.uint32((seed ^ _B_SALT) & 0xFFFFFFFF)).view(np.int32)
    pay = murmur_fmix32_numpy(idx ^ np.uint32((seed ^ 0x2C2C2C2C)
                                              & 0xFFFFFFFF))
    return a, b, pay


def _make_run(r: int, n_run: int, a_card: int, seed: int, device):
    """Phase A: run r sorted, as int32 planes (t1, t2, t3, idx, pay)."""
    idx = narrow(torch.arange(r * n_run, (r + 1) * n_run, device=device))
    t1, t2, t3, pay = _cols_of(idx, a_card, seed)
    return sort_planes([t1, t2, t3, idx, pay], N_PLANES)


def _plan(runs, n_buckets: int, per_run: int) -> torch.Tensor:
    """Phase B: each run's (B-1,) segment boundaries (R, B-1), int64, at
    the bucket quantiles of strided samples of the runs' (t1, t2, t3,
    index) order."""
    samples = [[] for _ in range(4)]
    for cols in runs:
        n = cols[0].shape[0]
        sel = torch.arange(per_run, device=cols[0].device) * max(
            n // per_run, 1) % n
        for j in range(4):
            samples[j].append(cols[j][sel])
    g = sort_planes([torch.cat(s) for s in samples], 4)
    total = g[0].shape[0]
    q = torch.arange(1, n_buckets, device=g[0].device) * total // n_buckets
    sp = [p[q] for p in g]
    return torch.stack([_searchsorted_multi(cols[:4], sp) for cols in runs])


def _bucket(st1, st2, st3, sidx, spay, carry, a_card: int, seed: int):
    """Phase C's checks over one sorted bucket (int32 planes): (checks
    (4,) int64: sorted, hash, boundary, count; carry out (6,) int64 of u32
    values). carry: (6,) int64 of u32 values, the previous bucket's."""
    m = sidx.shape[0]
    dev = sidx.device
    if m == 0:      # an empty bucket: every check holds, the carry passes
        return torch.tensor([1, 1, 1, 0], device=dev), carry
    # lexicographic order of (t1, t2, t3, idx), index tie-break included,
    # compared unsigned
    k1, k2 = signed_key(st2, st1), signed_key(sidx, st3)
    s_ok = ((k1[:-1] < k1[1:])
            | ((k1[:-1] == k1[1:]) & (k2[:-1] < k2[1:]))).all()
    # the bucket's first row comes after the carry's last
    blt = torch.zeros((), dtype=torch.bool, device=dev)
    for i, p in ((3, sidx), (2, st3), (1, st2), (0, st1)):
        cv = widen(p[0])
        blt = (carry[i] < cv) | ((carry[i] == cv) & blt)
    # every row re-derives its planes from its index
    w1, w2, w3, wpay = _cols_of(sidx, a_card, seed)
    h_ok = ((st1 == w1) & (st2 == w2) & (st3 == w3) & (spay == wpay)).all()
    # the exact running index sum (permutation certificate)
    acc = _u64_bits(carry[4], carry[5]) + widen(sidx).sum()
    last = [widen(p[-1:]) for p in (st1, st2, st3, sidx)]
    new_carry = torch.cat(last + [(acc & U32_MASK).view(1),
                                  ((acc >> 32) & U32_MASK).view(1)])
    checks = torch.cat([torch.stack([s_ok, h_ok, blt]).to(torch.int64),
                        torch.full((1,), m, dtype=torch.int64, device=dev)])
    return checks, new_carry


@dataclasses.dataclass(frozen=True)
class BigOrderByResult:
    n: int
    a_card: int
    seconds: float
    rows_per_s: float
    sorted_ok: bool
    hash_ok: bool
    boundary_ok: bool
    count_ok: bool
    perm_ok: bool
    phase_a_s: float
    phase_c_s: float
    compile_s: float

    @property
    def all_ok(self) -> bool:
        return (self.sorted_ok and self.hash_ok and self.boundary_ok
                and self.count_ok and self.perm_ok)


def order_by_big(n: int, a_card: int | None = None,
                 run_size: int = 1 << 26, n_buckets: int | None = None,
                 seed: int = 7, samples_per_run: int = 4096,
                 verbose: bool = False, collect: bool = False,
                 device: str | torch.device = "cuda"):
    """Out-of-core ORDER BY a DESC, b ASC over n rows generated on the
    device (module docstring); on the card unless `device` names another.
    n must be a multiple of run_size and < 2^31. collect=True (tests) also
    returns the ordered columns as numpy arrays."""
    assert n % run_size == 0, (n, run_size)
    assert n < (1 << 31), n
    if a_card is None:
        a_card = max(n // 256, 1)
    n_runs = n // run_size
    if n_buckets is None:
        n_buckets = max(2, int(np.ceil(n / (1 << 26))))
    dev = resolve_device(device)
    compile_s = _build_seconds(dev)

    t0 = _fence(dev)
    with span("bigorderby phase A: sorted runs"):
        runs = [_make_run(r, run_size, a_card, seed, dev)
                for r in range(n_runs)]
    t_a = _fence(dev) - t0

    t0 = _fence(dev)
    with span("bigorderby phase B: plan"):
        bounds = _plan(runs, n_buckets, samples_per_run).cpu().numpy()
    t_b = _fence(dev) - t0
    starts = np.concatenate([np.zeros((n_runs, 1), np.int64), bounds],
                            axis=1)
    ends = np.concatenate([bounds, np.full((n_runs, 1), run_size)], axis=1)
    if verbose:
        print(f"bigorderby: {n_runs} runs x {run_size}, {n_buckets} "
              f"buckets, largest segment {int((ends - starts).max())}")

    t1 = _fence(dev)
    # bucket 0's boundary check compares against this zero carry and is
    # left out on the host below (it has no predecessor)
    carry = torch.zeros(N_CARRY, dtype=torch.int64, device=dev)
    outs, collected = [], []
    with span("bigorderby phase C: buckets"):
        for b in range(n_buckets):
            cols = [torch.cat([run[c][starts[r, b]:ends[r, b]]
                               for r, run in enumerate(runs)])
                    for c in range(N_COLS)]
            srt = sort_planes(cols, N_PLANES)
            del cols
            checks, carry = _bucket(*srt, carry, a_card, seed)
            outs.append(checks)
            if collect:
                collected.append(srt)
            del srt
        scal = torch.stack(outs).cpu().numpy()      # the read-back fences
        fin = carry.cpu().numpy()
    t_c = _fence(dev) - t1
    isum = int(fin[4]) | (int(fin[5]) << 32)

    secs = t_a + t_b + t_c
    res = BigOrderByResult(
        n=n, a_card=a_card, seconds=secs, rows_per_s=n / secs,
        sorted_ok=bool(scal[:, 0].all()), hash_ok=bool(scal[:, 1].all()),
        boundary_ok=bool(scal[1:, 2].all()),
        count_ok=int(scal[:, 3].sum()) == n,
        perm_ok=isum == n * (n - 1) // 2,
        phase_a_s=t_a, phase_c_s=t_c, compile_s=compile_s)
    if verbose:
        print(f"bigorderby: {secs:.2f}s ok={res.all_ok}")
    if collect:
        t1, t2, t3, ridx, pay = (np.concatenate(
            [c[j].cpu().numpy().view(np.uint32) for c in collected])
            for j in range(N_COLS))
        # untransform: a = (~t1, ~t2), b = t3 ^ sign bit
        a = ((~t2).astype(np.uint64)
             | ((~t1).astype(np.uint64) << np.uint64(32)))
        b = (t3 ^ np.uint32(0x80000000)).view(np.int32)
        return res, {"a": a, "b": b, "idx": ridx, "pay": pay}
    return res
