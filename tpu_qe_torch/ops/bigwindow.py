"""Out-of-core window functions on one device, past one in-core sort: the
port of tpu_qe/ops/bigwindow.py.

A window is a segmented scan over the (partition, order, position)-sorted
stream, and segmented scans compose across any cut through a monoid
carry. Here the cuts are the out-of-core sort's bucket boundaries:

  phase A   R sorted runs, each generated on the device from the
            regenerable index hash (partition key, order and value are
            closed forms of the global row index) and sorted by the whole
            window order (key, order, index);
  phase B   one splitter plan on the same composite order (4-plane sample
            quantiles, then a lexicographic binary search per run), so a
            hot partition splits across buckets and bucket sizes stay
            balanced under any skew;
  phase C   per bucket in global order: concatenate the runs' segments,
            sort, compute the window planes (ops/window.py's sweeps), patch
            the partition that crosses the boundary with the carry from the
            previous bucket and emit the next carry: 9 scalars in a device
            tensor, chained bucket to bucket with no read-back.

The function set is fixed (the benchmark's data model): row_number, rank,
running_sum (exact u64) and lag. Each bucket is verified on the device:
composite sortedness, every row's key / order / value against the closed
forms of its index, and every window column re-derived from its
sequential recurrence, seamed against the carry at row 0.

Differences from the reference, none of which changes a result:
- Every sort is ``sort_planes`` (B1-B3 on the card) and stable. The
  reference sorts a run by (key hi, key lo, order, index) unstably; the
  port sorts it stably by (key hi, key lo, order), 12 LSD passes where
  the fourth key would add 4: a run is generated in index order, so rows
  of equal (key, order) already stand in ascending index order, which is
  the order the index key gives. A bucket is the concatenation of the runs'
  segments in run order, run r holds indices [r * run_size, (r + 1) *
  run_size), and each segment is in index order within its ties, so the
  same stable sort gives the same order there.
- Segments are sliced exactly: no padding to a static capacity, no
  sentinel rows; a bucket holds n_valid rows. `window_core` keeps the
  reference's pad handling (bit 31 of the index plane) for callers that
  pad.
- `window_core` works on int64 tensors of u32 values (carry, checks and
  output planes), and the running sum is an int64 sum mod 2^64, exact for
  the < 2^31 rows of u32 values it may hold. Every compare of u32 planes
  is unsigned (widened, or through ``sort.driver.signed_key``).
- The check scalars are read back once after the chain, or per bucket
  when checkpointing; the checkpoint stores them and the carry as u32
  values, so a RunState written by either package resumes in the other
  (same file, meta and plan).

Phases are fenced with torch.cuda.synchronize(). `compile_s` is the time
the CUDA kernels took to build at first use (0 when they were built, and
on the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_qe_torch.bits import U32_MASK, U64, mul_lo32, narrow, widen
from tpu_qe_torch.config import resolve_device
from tpu_qe_torch.hashing import _fmix32, murmur_fmix32_numpy
from tpu_qe_torch.ops.window import _window_sorted_cols
from tpu_qe_torch.sort.bigsort import _build_seconds, _fence
from tpu_qe_torch.sort.driver import signed_key
from tpu_qe_torch.sort.planes import sort_planes
from tpu_qe_torch.table import from_plane
from tpu_qe_torch.utils.checkpoint import RunState
from tpu_qe_torch.utils.profiling import span

_O_SALT = 0x6F726472
_V_SALT = 0x76616C75

# the verified spec (name, kind, col, fill), in canonical order by name
WSPEC = (("cum", "running_sum", "v", 0), ("lg", "lag", "v", 0),
         ("rk", "rank", None, 0), ("rn", "row_number", None, 0))
N_CARRY = 9   # have, lk_lo, lk_hi, lord, cnt, rank, sum_lo, sum_hi, lastv
N_CHECK = 10  # s_ok, h_ok, w_ok, cnt, flo, fhi, f_ord, llo, lhi, l_ord


def _mix(x: torch.Tensor, salt: int) -> torch.Tensor:
    """murmur_fmix32(x ^ salt) on int64 u32 values, as int64."""
    return _fmix32(x ^ (salt & U32_MASK))


def _pk(idx: torch.Tensor, partitions: int, seed: int) -> torch.Tensor:
    """Partition of rows `idx` (an int32 plane), as int64."""
    return _mix(widen(idx), seed) % partitions


def _key_of(idx: torch.Tensor, partitions: int, seed: int) -> U64:
    pk = _pk(idx, partitions, seed)
    # pk -> u64 key injectively (lo is a bijection of pk), so distinct
    # partitions stay distinct and key order is a permutation of pk order
    return U64(narrow(mul_lo32(pk, 2654435761)),
               narrow(_mix(pk, 0x9E3779B9)))


def _ord_of(idx: torch.Tensor, seed: int) -> torch.Tensor:
    return narrow(_mix(widen(idx), seed ^ _O_SALT))


def _val_of(idx: torch.Tensor, seed: int) -> torch.Tensor:
    return narrow(_mix(widen(idx), seed ^ _V_SALT))


def rows_numpy(idx: np.ndarray, partitions: int, seed: int = 7):
    """Host twin of the data model (oracle tests): (key64, order, value)."""
    pk = murmur_fmix32_numpy(idx.astype(np.uint32) ^ np.uint32(seed)) \
        % np.uint32(partitions)
    lo = pk * np.uint32(2654435761)
    hi = murmur_fmix32_numpy(pk ^ np.uint32(0x9E3779B9))
    key = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    o = murmur_fmix32_numpy(idx.astype(np.uint32)
                            ^ np.uint32((seed ^ _O_SALT) & 0xFFFFFFFF))
    v = murmur_fmix32_numpy(idx.astype(np.uint32)
                            ^ np.uint32((seed ^ _V_SALT) & 0xFFFFFFFF))
    return key, o, v


def _make_run(r: int, n_run: int, partitions: int, seed: int, device):
    """Phase A: run r generated and sorted by (key, order, index), as int32
    planes (lo, hi, o, idx, v)."""
    idx = narrow(torch.arange(r * n_run, (r + 1) * n_run, device=device))
    key = _key_of(idx, partitions, seed)
    shi, slo, so, sidx, sv = sort_planes(
        [key.hi, key.lo, _ord_of(idx, seed), idx, _val_of(idx, seed)], 3)
    return slo, shi, so, sidx, sv


def _searchsorted_multi(planes, q_planes):
    """Lexicographic binary search (side 'left') of the queries q_planes
    in rows sorted by the u32 planes (most significant first): the
    reference's fixed-step search, compared unsigned; int64 positions."""
    m = planes[0].shape[0]
    qshape = q_planes[0].shape
    dev = q_planes[0].device
    wq = [widen(q) for q in q_planes]
    lo_b = torch.zeros(qshape, dtype=torch.int64, device=dev)
    hi_b = torch.full(qshape, m, dtype=torch.int64, device=dev)
    for _ in range(m.bit_length()):
        done = lo_b >= hi_b
        mid = torch.clamp((lo_b + hi_b) // 2, max=m - 1)
        lt = torch.zeros(qshape, dtype=torch.bool, device=dev)
        for p, q in zip(reversed(planes), reversed(wq)):
            pv = widen(p[mid])
            lt = (pv < q) | ((pv == q) & lt)
        go_right = lt & ~done
        lo_b = torch.where(go_right, mid + 1, lo_b)
        hi_b = torch.where(go_right | done, hi_b, mid)
    return lo_b


def _plan(runs, n_buckets: int, per_run: int):
    """Phase B: composite (key, order, index) splitters and each run's
    (B-1,) segment boundaries: quantiles of the whole window order, so a
    hot partition splits across buckets (the carry chain composes it).
    Returns (splitter key hi, key lo, bounds (R, B-1) int64)."""
    samples = [[] for _ in range(4)]
    for lo, hi, o, idx, _v in runs:
        n = lo.shape[0]
        sel = torch.arange(per_run, device=lo.device) * max(
            n // per_run, 1) % n
        for j, p in enumerate((hi, lo, o, idx)):
            samples[j].append(p[sel])
    g = sort_planes([torch.cat(s) for s in samples], 4)
    total = g[0].shape[0]
    q = torch.arange(1, n_buckets, device=g[0].device) * total // n_buckets
    sp = [p[q] for p in g]
    bounds = [_searchsorted_multi((hi, lo, o, idx), sp)
              for lo, hi, o, idx, _v in runs]
    return sp[0], sp[1], torch.stack(bounds)


def _prev(x: torch.Tensor) -> torch.Tensor:
    """x shifted down one row, zero in front."""
    return torch.cat([x.new_zeros(1), x[:-1]])


def _u64_bits(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """int64 with the bits of the u64 (hi, lo); lo and hi int32 planes or
    int64 u32 values."""
    h = hi if hi.dtype == torch.int32 else narrow(hi)
    return (h.to(torch.int64) << 32) | (widen(lo) if lo.dtype == torch.int32
                                        else lo)


def window_core(shi, slo, so, sidx, sv, n_valid, carry,
                partitions: int, seed: int):
    """Window planes, carry patch and construction-exact verification over
    one stream sorted by (key, order, index), int32 planes; rows past
    n_valid (an int or a 0-d tensor) are pads with bit 31 of the index
    plane set.

    The phase-C core of the out-of-core window: window_big's bucket chain
    (and, at the reference, the distributed bucket rounds). carry: (9,)
    int64 tensor of u32 values. Returns (checks (10,) int64, carry_out
    (9,) int64, planes (rn, rk, cum_lo, cum_hi, lg) int64), every value a
    u32 value."""
    m = slo.shape[0]
    dev = slo.device
    if m == 0:      # an empty stream: the carry passes through
        return (torch.tensor([1, 1, 1, 0] + [U32_MASK] * 6, device=dev),
                carry, (torch.zeros(0, dtype=torch.int64, device=dev),) * 5)
    spad = sidx < 0
    pos = torch.arange(m, device=dev)
    valid = pos < n_valid
    first = pos == 0
    is_new = (first | (slo != _prev(slo)) | (shi != _prev(shi))
              | (spad & ~_prev(spad)))
    order_new = is_new | (so != _prev(so))
    is_last = torch.cat([is_new[1:], is_new.new_ones(1)])
    out, aux = _window_sorted_cols(WSPEC, {"v": from_plane(sv, torch.uint32)},
                                   pos, is_new, order_new, is_last,
                                   need_aux=True)
    part_start, run_start = aux["part_start"], aux["run_start"]

    # --- patch the boundary partition with the previous bucket ---------
    have, plk_lo, plk_hi, plord, c_cnt, c_rank, c_slo, c_shi, c_lv = \
        carry.unbind()
    c_sum = _u64_bits(c_slo, c_shi)
    cont = (have > 0) & (widen(slo[0]) == plk_lo) & (widen(shi[0]) == plk_hi)
    cont_o = cont & (widen(so[0]) == plord)
    head = valid & (part_start == 0) & cont
    rn = widen(out["rn"].view(torch.int32)) + torch.where(head, c_cnt, 0)
    in_head_run = head & (run_start == 0) & cont_o
    rk = torch.where(in_head_run, c_rank,
                     widen(out["rk"].view(torch.int32))
                     + torch.where(head, c_cnt, 0))
    cum = _u64_bits(*out["cum"]) + torch.where(head, c_sum, 0)
    v = widen(sv)
    lg = torch.where(first & cont, c_lv, widen(out["lg"].view(torch.int32)))

    # --- construction-exact verification on the device -----------------
    # (key, order, index) order over the valid rows, compared unsigned
    k1, k2 = signed_key(slo, shi), signed_key(sidx, so)
    p1, p2 = _prev(k1), _prev(k2)
    ge = (k1 > p1) | ((k1 == p1) & (k2 >= p2))
    sorted_ok = (ge | first | ~valid).all()
    # each row's key, order and value are the generator's closed forms of
    # its own index: rows moved as units or this fails
    want = _key_of(sidx, partitions, seed)
    hash_ok = (~valid | ((slo == want.lo) & (shi == want.hi)
                         & (so == _ord_of(sidx, seed))
                         & (sv == _val_of(sidx, seed)))).all()
    # every window column re-derived by its sequential recurrence (apart
    # from the sweeps that computed it), seamed against the carry at row 0
    one = torch.ones_like(c_cnt)
    first_rn = torch.where(cont, c_cnt + 1, one)
    rn_want = torch.where(first, first_rn,
                          torch.where(is_new, 1, _prev(rn) + 1))
    rk_want = torch.where(
        first, torch.where(cont_o, c_rank, first_rn),
        torch.where(is_new, 1, torch.where(order_new, rn, _prev(rk))))
    cum_want = torch.where(is_new, v, _prev(cum) + v)
    cum_want = torch.where(first & cont, c_sum + v, cum_want)
    lg_want = torch.where(first, torch.where(cont, c_lv, 0),
                          torch.where(is_new, 0, _prev(v)))
    window_ok = (~valid | ((rn == rn_want) & (rk == rk_want)
                           & (cum == cum_want) & (lg == lg_want))).all()

    # --- carry out (passed through unchanged on an empty bucket) --------
    nv = n_valid if torch.is_tensor(n_valid) else torch.full(
        (), n_valid, dtype=torch.int64, device=dev)
    li = (torch.clamp(nv, min=1) - 1).view(1)
    last = [widen(slo[li]), widen(shi[li]), widen(so[li])]
    new = torch.cat([one.view(1), *last, rn[li], rk[li], cum[li] & U32_MASK,
                     (cum[li] >> 32) & U32_MASK, v[li]])
    carry_out = torch.where(nv > 0, new, carry)
    checks = torch.cat([torch.stack([sorted_ok, hash_ok, window_ok]).to(
        torch.int64), nv.view(1).to(torch.int64), widen(slo[:1]),
        widen(shi[:1]), widen(so[:1]), *last])
    return checks, carry_out, (rn, rk, cum & U32_MASK,
                               (cum >> 32) & U32_MASK, lg)


@dataclasses.dataclass(frozen=True)
class BigWindowResult:
    n: int
    partitions: int
    seconds: float
    rows_per_s: float
    sorted_ok: bool
    hash_ok: bool
    window_ok: bool
    count_ok: bool
    boundary_ok: bool
    phase_a_s: float
    phase_c_s: float
    compile_s: float

    @property
    def all_ok(self) -> bool:
        return (self.sorted_ok and self.hash_ok and self.window_ok
                and self.count_ok and self.boundary_ok)


def window_big(n: int, partitions: int | None = None,
               run_size: int = 1 << 26, n_buckets: int | None = None,
               seed: int = 7, samples_per_run: int = 4096,
               verbose: bool = False, collect: bool = False,
               checkpoint_dir: str | None = None,
               device: str | torch.device = "cuda"):
    """Out-of-core window (row_number, rank, exact u64 running sum, lag)
    over n rows generated on the device (module docstring); on the card
    unless `device` names another.

    n must be a multiple of run_size and < 2^31 (a pad flag rides bit 31
    of the index plane). Device memory: 20 bytes a row of resident runs
    plus one bucket's working set. The buckets chain their carry as a
    device tensor, so phase C queues with no read-back; checkpoint_dir
    adds a read-back per bucket to persist it, and a resumed run replays
    the done prefix of buckets (the chain is sequential) from the stored
    scalars and carry. collect=True (tests) also returns every row and
    window column as numpy arrays.
    """
    assert n % run_size == 0, (n, run_size)
    assert n < (1 << 31), "pad flag rides bit 31 of the index plane"
    if partitions is None:
        partitions = max(n // 1024, 1)
    n_runs = n // run_size
    if n_buckets is None:
        n_buckets = max(2, int(np.ceil(n / (1 << 26))))
    meta = np.asarray([n, partitions, run_size, n_buckets, seed,
                       samples_per_run, 0xB16], dtype=np.int64)
    state = (RunState.load(checkpoint_dir, meta)
             if checkpoint_dir is not None else None)
    dev = resolve_device(device)
    compile_s = _build_seconds(dev)

    t0 = _fence(dev)
    with span("bigwindow phase A: sorted runs"):
        runs = [_make_run(r, run_size, partitions, seed, dev)
                for r in range(n_runs)]
    t_a = _fence(dev) - t0

    if state is not None:
        bounds = state.bounds
        t_b = 0.0
    else:
        t0 = _fence(dev)
        with span("bigwindow phase B: plan"):
            bounds = _plan(runs, n_buckets, samples_per_run)[2].cpu(
            ).numpy().astype(np.int32)
        t_b = _fence(dev) - t0
        if checkpoint_dir is not None:
            state = RunState.fresh(checkpoint_dir, meta, bounds, n_buckets,
                                   n_scalars=N_CHECK + N_CARRY)
    starts = np.concatenate([np.zeros((n_runs, 1), np.int64), bounds],
                            axis=1).astype(np.int64)            # (R, B)
    ends = np.concatenate([bounds, np.full((n_runs, 1), run_size)],
                          axis=1).astype(np.int64)
    if verbose:
        print(f"bigwindow: {n_runs} runs x {run_size}, {n_buckets} "
              f"buckets, largest segment {int((ends - starts).max())}")

    t1 = _fence(dev)
    scal = np.zeros((n_buckets, N_CHECK), np.int64)
    carry = torch.zeros(N_CARRY, dtype=torch.int64, device=dev)
    start_b = 0
    if state is not None and not collect:
        # resume: replay the done prefix (the carry chain is sequential)
        while start_b < n_buckets and state.done[start_b]:
            scal[start_b] = state.scalars[start_b, :N_CHECK]
            start_b += 1
        if start_b > 0:
            carry = torch.tensor(
                state.scalars[start_b - 1, N_CHECK:] & U32_MASK,
                dtype=torch.int64, device=dev)
            if verbose:
                print(f"bigwindow: resuming — {start_b}/{n_buckets} "
                      "buckets replayed from checkpoint")
    pending = {}
    with span("bigwindow phase C: buckets"):
        for b in range(start_b, n_buckets):
            lo, hi, o, idx, v = (torch.cat([
                run[c][starts[r, b]:ends[r, b]]
                for r, run in enumerate(runs)]) for c in range(5))
            srt = sort_planes([hi, lo, o, idx, v], 3)
            del lo, hi, o, idx, v
            shi, slo, so, sidx, sv = srt
            checks, carry, planes = window_core(
                shi, slo, so, sidx, sv, slo.shape[0], carry, partitions,
                seed)
            pending[b] = (checks, [slo, shi, so, sidx, sv, *planes]
                          if collect else None)
            del srt, shi, slo, so, sidx, sv, planes
            if state is not None:
                # checkpointing reads each bucket back: the carry must be
                # stored for the resumed prefix to mean anything
                vals = [x & U32_MASK for x in checks.tolist()
                        + carry.tolist()]
                scal[b] = vals[:N_CHECK]
                state.record(b, vals)
        if pending and state is None:
            got = torch.stack([c for c, _ in pending.values()]).cpu()
            scal[list(pending)] = got.numpy()
    collected = []
    for b, (_, arrays) in pending.items():
        if collect:
            collected.append([a.cpu().numpy().astype(np.uint32)
                              for a in arrays])
        if verbose:
            print(f"  bucket {b}: {scal[b, 3]} rows "
                  f"sorted={bool(scal[b, 0])} hash={bool(scal[b, 1])} "
                  f"window={bool(scal[b, 2])}")
    t_c = _fence(dev) - t1

    total = 0
    all_sorted = all_hash = all_window = boundary_ok = True
    prev_last = None
    for b in range(n_buckets):
        s_ok, h_ok, w_ok, cnt, flo, fhi, fo, llo, lhi, lo_ = (
            int(x) for x in scal[b])
        all_sorted &= bool(s_ok)
        all_hash &= bool(h_ok)
        all_window &= bool(w_ok)
        total += cnt
        # u32 values as non-negative ints: the tuple order is unsigned
        if prev_last is not None and cnt > 0:
            boundary_ok &= prev_last <= (fhi, flo, fo)
        if cnt > 0:
            prev_last = (lhi, llo, lo_)
    dt = t_a + t_b + t_c
    res = BigWindowResult(
        n=n, partitions=partitions, seconds=dt, rows_per_s=n / dt,
        sorted_ok=all_sorted, hash_ok=all_hash, window_ok=all_window,
        count_ok=(total == n), boundary_ok=boundary_ok,
        phase_a_s=t_a, phase_c_s=t_c, compile_s=compile_s)
    if collect:
        slo, shi, so, sidx, sv, rn, rk, clo, chi, lg = (
            np.concatenate([c[j] for c in collected]) for j in range(10))
        keys = slo.astype(np.uint64) | (shi.astype(np.uint64)
                                        << np.uint64(32))
        cum = clo.astype(np.uint64) | (chi.astype(np.uint64)
                                       << np.uint64(32))
        return res, dict(key=keys, order=so, idx=sidx, value=sv,
                         rn=rn, rk=rk, cum=cum, lg=lg)
    return res
