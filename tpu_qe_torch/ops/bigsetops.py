"""Out-of-core UNION / INTERSECT / EXCEPT (DISTINCT semantics) past what
the card holds: the port of tpu_qe/ops/bigsetops.py.

  phase A   per run, per side: generate keys on the device, sort, and
            compact the distinct keys with their occurrence counts to a
            prefix padded to partial_cap rows (all-ones keys, zero
            counts); overflow is detected from the exact count;
  phase B   one combine over every table of both sides (a side plane
            riding along): a key sort, per-key side multiplicities from
            two cumulative sums (cross-run and cross-side duplicates
            collapse), the op's predicate, and a compaction of the
            qualifying keys with their multiplicities.

Data model: side A holds n_a rows with key = idx mod g_a; side B n_b rows
with key = idx mod g_b + offset. For every distinct key the combine checks
count_a and count_b against their closed forms and strictly ascending
keys, and the host holds the qualifying-key count to numpy's closed form:
together these pin the exact result set.

Every sort is ``sort_planes`` (B1-B3 on the card), phase A's with the key
bits the data model bounds; the packed-position compactions of the
reference are ``stable_partition``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_qe_torch.bits import narrow, widen
from tpu_qe_torch.config import resolve_device
from tpu_qe_torch.ops.aggregate import _ends, _shift_right_one
from tpu_qe_torch.ops.bigagg import _ONES, _cut, _u32
from tpu_qe_torch.ops.bigdistinct import _bits, _run_ends
from tpu_qe_torch.ops.filter import stable_partition
from tpu_qe_torch.ops.setops import _OPS, _qualifies
from tpu_qe_torch.sort.bigsort import _build_seconds, _fence
from tpu_qe_torch.sort.planes import sort_planes
from tpu_qe_torch.utils.profiling import span


def keys_of_index(idx: torch.Tensor, n_groups: int, offset: int):
    """Side key (int32 plane) of int64 global row indices."""
    return narrow(idx % n_groups + offset)


def side_counts_numpy(keys: np.ndarray, n_rows: int, n_groups: int,
                      offset: int) -> np.ndarray:
    """Closed-form multiplicity of each key in a side's bag."""
    k = keys.astype(np.int64) - offset
    inside = (k >= 0) & (k < n_groups)
    extra = k < (n_rows % n_groups)
    return np.where(inside,
                    n_rows // n_groups + extra.astype(np.int64),
                    0).astype(np.uint32)


def expected_result_numpy(op: str, n_a: int, g_a: int, n_b: int,
                          g_b: int, offset: int):
    """The full expected (keys, count_a, count_b) by closed form."""
    dom = np.arange(max(g_a, offset + g_b), dtype=np.uint32)
    ca = side_counts_numpy(dom, n_a, g_a, 0)
    cb = side_counts_numpy(dom, n_b, g_b, offset)
    keep = np.asarray(_qualifies(op, ca > 0, cb > 0))
    return dom[keep], ca[keep], cb[keep]


def _dedup_run(r: int, run_size: int, n_groups: int, offset: int,
               partial_cap: int, device):
    """Phase A: one side-run's distinct (key, occurrences) padded table
    and its exact distinct-key count (0-d, overflow detection)."""
    idx = torch.arange(r * run_size, (r + 1) * run_size, device=device)
    (sk,) = sort_planes([keys_of_index(idx, n_groups, offset)], 1,
                        key_bits=[_bits(offset + n_groups)])
    pos = torch.arange(run_size, device=device)
    key_new = (pos == 0) | (sk != _shift_right_one(sk, 0))
    m = key_new.sum()
    order, occ = _run_ends(key_new)
    valid = torch.arange(partial_cap, device=device) < m
    return _cut(sk[order], valid, _ONES), _cut(occ, valid, 0), m


def _combine(klo, side, occ, op: str, n_a: int, g_a: int, n_b: int,
             g_b: int, offset: int, collect: bool):
    """Phase B: merge all partial tables, qualify, verify the closed form.

    Returns (checks, planes): checks the Python values (counts_ok,
    keys_ok, num); planes (collect only) the qualifying keys and both
    multiplicities as int32 planes, all ones / zero past them. Sentinel
    rows (all-ones key, zero occurrences) sort last."""
    m = klo.shape[0]
    dev = klo.device
    sk, ss, so = sort_planes([klo, side, occ], 1)
    pos = torch.arange(m, device=dev)
    sent = sk == _ONES
    key_new = ((pos == 0) | (sk != _shift_right_one(sk, 0))) & ~sent
    key_end = ~sent & _ends(key_new | sent)
    n_keys = key_end.sum()
    so = widen(so)
    cum_b = torch.cumsum(so * widen(ss), 0)   # side-B occurrences so far
    cum_tot = torch.cumsum(so, 0)
    order = stable_partition(key_end)
    gkey = widen(sk[order])
    b_end, t_end = cum_b[order], cum_tot[order]
    cb = b_end - _shift_right_one(b_end, 0)
    ca = t_end - _shift_right_one(t_end, 0) - cb
    gvalid = pos < n_keys
    # closed-form per-key certificate (module docstring)
    want_ca = torch.where(gkey < g_a,
                          n_a // g_a + (gkey < n_a % g_a).to(torch.int64),
                          0)
    kb = gkey - offset
    in_b = (gkey >= offset) & (kb < g_b)
    want_cb = torch.where(in_b,
                          n_b // g_b + (kb < n_b % g_b).to(torch.int64), 0)
    counts_ok = (~gvalid | ((ca == want_ca) & (cb == want_cb))).all()
    keys_ok = (~gvalid[1:] | (gkey[1:] > gkey[:-1])).all()
    keep = gvalid & _qualifies(op, ca > 0, cb > 0)
    num = keep.sum()
    c_ok, k_ok, num = torch.stack([counts_ok, keys_ok, num]).tolist()
    checks = (bool(c_ok), bool(k_ok), int(num))
    if not collect:
        return checks, ()
    order2 = stable_partition(keep)
    rvalid = pos < num
    return checks, (torch.where(rvalid, narrow(gkey[order2]), _ONES),
                    torch.where(rvalid, narrow(ca[order2]), 0),
                    torch.where(rvalid, narrow(cb[order2]), 0))


@dataclasses.dataclass
class BigSetOpResult:
    op: str
    n_a: int
    n_b: int
    g_a: int
    g_b: int
    offset: int
    n_runs_a: int
    n_runs_b: int
    num: int                  # qualifying keys found on the device
    expected_num: int         # numpy closed form
    counts_ok: bool
    keys_ok: bool
    overflow: bool
    seconds: float
    dedup_s: float
    combine_s: float
    rows_per_s: float
    table: dict | None = None

    @property
    def all_ok(self) -> bool:
        return (self.counts_ok and self.keys_ok and not self.overflow
                and self.num == self.expected_num)


def set_op_big(op: str, n_a: int, n_b: int, g_a: int = 1 << 20,
               g_b: int = 1 << 20, offset: int = 1 << 19,
               run_size: int = 1 << 26, partial_cap: int | None = None,
               collect: bool = False, verbose: bool = False,
               device: str | torch.device = "cuda") -> BigSetOpResult:
    """DISTINCT-semantics set operation over two key bags generated on the
    device, out of core (module docstring); on the card unless `device`
    names another."""
    if op not in _OPS:
        raise ValueError(f"op must be one of {_OPS}, got {op!r}")
    for n, nm in ((n_a, "n_a"), (n_b, "n_b")):
        assert n % run_size == 0, (nm, n, run_size)
    assert n_a + n_b < (1 << 32)
    assert max(g_a, offset + g_b) < (1 << 32) - 1
    dev = resolve_device(device)
    runs_a, runs_b = n_a // run_size, n_b // run_size
    caps = {}
    for s, g in ((0, g_a), (1, g_b)):
        caps[s] = partial_cap if partial_cap is not None \
            else min(-(-min(run_size, g) // 128) * 128, run_size)
    _build_seconds(dev)             # the kernels' build stays untimed

    t0 = _fence(dev)
    parts, sides, m_counts, cap_of = [], [], [], []
    with span("bigsetops phase A: run dedup"):
        for s, runs, g, off in ((0, runs_a, g_a, 0),
                                (1, runs_b, g_b, offset)):
            for rr in range(runs):
                klo, occ, mcnt = _dedup_run(rr, run_size, g, off, caps[s],
                                            dev)
                parts.append((klo, occ))
                sides.append(torch.full((caps[s],), s, dtype=torch.int32,
                                        device=dev))
                m_counts.append(mcnt)
                cap_of.append(caps[s])
        m_host = np.array(torch.stack(m_counts).tolist())   # fence A
    overflow = bool((m_host > np.array(cap_of)).any())
    t1 = _fence(dev)
    with span("bigsetops phase B: combine"):
        klo = torch.cat([p[0] for p in parts])
        side = torch.cat(sides)
        occ = torch.cat([p[1] for p in parts])
        del parts, sides
        (counts_ok, keys_ok, num), planes = _combine(
            klo, side, occ, op, n_a, g_a, n_b, g_b, offset, collect)
    t2 = _fence(dev)
    ek, _, _ = expected_result_numpy(op, n_a, g_a, n_b, g_b, offset)
    table = None
    if collect:
        gk, ca_p, cb_p = (_u32(p) for p in planes)
        keep = gk != 0xFFFFFFFF
        table = {"key": gk[keep], "count_a": ca_p[keep],
                 "count_b": cb_p[keep]}
    if verbose:
        print(f"bigsetops[{op}]: {runs_a}+{runs_b} runs dedup "
              f"{t1 - t0:.2f}s (keys/run max {m_host.max()}), combine "
              f"{t2 - t1:.2f}s, {num} keys")
    secs = t2 - t0
    return BigSetOpResult(
        op=op, n_a=n_a, n_b=n_b, g_a=g_a, g_b=g_b, offset=offset,
        n_runs_a=runs_a, n_runs_b=runs_b, num=num,
        expected_num=len(ek), counts_ok=counts_ok, keys_ok=keys_ok,
        overflow=overflow, seconds=secs, dedup_s=t1 - t0,
        combine_s=t2 - t1, rows_per_s=(n_a + n_b) / secs, table=table)
