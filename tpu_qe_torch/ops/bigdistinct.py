"""Out-of-core COUNT(DISTINCT value) GROUP BY key, dedup as compression:
the port of tpu_qe/ops/bigdistinct.py.

  phase A   per run: generate rows on the device, sort by (key, value),
            and compact the run's distinct pairs with their occurrence
            counts to a prefix padded to partial_cap rows (all-ones keys,
            zero counts). A run with more distinct pairs than partial_cap
            is detected from the exact count, never truncated silently;
  phase B   one combine over the R tables: a (key, value) sort (a pair
            seen by many runs counts once), per-key distinct counts and
            row counts (the occurrence counts sum), compaction, and
            verification on the device against the data model.

Data model: key = idx mod G, value = (idx div G) mod V, so group g holds
n // G rows (one more for g < n mod G) with min(rows, V) distinct values;
the combine checks num_groups == min(G, n), every distinct count, every
row count and strictly ascending keys.

Every sort is ``sort_planes`` (B1-B3 on the card), with the key bits the
data model bounds (the key below G, the value below V) and all 32 bits of
the combine's key plane, whose sentinels are all ones. The reference's
packed-position compaction sorts are ``stable_partition``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_qe_torch.bits import narrow, widen
from tpu_qe_torch.config import resolve_device
from tpu_qe_torch.ops.aggregate import _ends, _shift_right_one
from tpu_qe_torch.ops.bigagg import _ONES, _cut, _u32
from tpu_qe_torch.ops.filter import stable_partition
from tpu_qe_torch.sort.bigsort import _build_seconds, _fence
from tpu_qe_torch.sort.planes import sort_planes
from tpu_qe_torch.utils.profiling import span


def _bits(bound: int) -> int:
    """Key bits that hold every value below `bound`."""
    return min(max(1, (bound - 1).bit_length()), 32)


def _run_ends(is_new: torch.Tensor):
    """Sorted rows' run ends moved to the front (stable partition) and
    each run's length as an int32 plane, aligned with them."""
    order = stable_partition(_ends(is_new))
    pe = order + 1
    return order, narrow(pe - _shift_right_one(pe, 0))


def rows_of_index(idx: torch.Tensor, n_groups: int, n_values: int):
    """(key, value) int32 planes of int64 global row indices."""
    return narrow(idx % n_groups), narrow(idx // n_groups % n_values)


def rows_of_index_numpy(idx: np.ndarray, n_groups: int, n_values: int):
    idx = idx.astype(np.uint64)
    return ((idx % np.uint64(n_groups)).astype(np.uint32),
            ((idx // np.uint64(n_groups)) % np.uint64(n_values))
            .astype(np.uint32))


def _dedup_run(r: int, run_size: int, n_groups: int, n_values: int,
               partial_cap: int, device):
    """Phase A: run r's distinct (key, value, occurrences) padded table
    and its exact distinct-pair count (0-d, overflow detection)."""
    idx = torch.arange(r * run_size, (r + 1) * run_size, device=device)
    g, v = rows_of_index(idx, n_groups, n_values)
    sg, sv = sort_planes([g, v], 2, key_bits=[_bits(n_groups),
                                              _bits(n_values)])
    pos = torch.arange(run_size, device=device)
    pair_new = ((pos == 0) | (sg != _shift_right_one(sg, 0))
                | (sv != _shift_right_one(sv, 0)))
    m = pair_new.sum()
    order, occ = _run_ends(pair_new)
    valid = torch.arange(partial_cap, device=device) < m
    return (_cut(sg[order], valid, _ONES), _cut(sv[order], valid, 0),
            _cut(occ, valid, 0), m)


def _combine(klo, v, occ, n: int, n_groups: int, n_values: int,
             collect: bool):
    """Phase B: merge the concatenated partial pair tables and verify.

    Returns (checks, planes): checks the Python values (groups_ok, cd_ok,
    cnt_ok, keys_ok, num_groups); planes (collect only) key, distinct
    count and row count as int32 planes, all ones / zero past the groups.
    Sentinel rows (all-ones key, zero occurrences) sort last and form no
    group."""
    m = klo.shape[0]
    dev = klo.device
    skey, sv, socc = sort_planes([klo, v, occ], 2,
                                 key_bits=[32, _bits(n_values)])
    pos = torch.arange(m, device=dev)
    sent = skey == _ONES
    key_new = ((pos == 0) | (skey != _shift_right_one(skey, 0))) & ~sent
    pair_new = (key_new | (sv != _shift_right_one(sv, 0))) & ~sent
    key_end = ~sent & _ends(key_new | sent)
    num_groups = key_end.sum()
    cum_nd = torch.cumsum(pair_new.to(torch.int64), 0)
    cum_occ = torch.cumsum(widen(socc), 0)   # n < 2^32 rows in all
    # key-end rows to the front: distinct and row counts per key
    order = stable_partition(key_end)
    gkey = widen(skey[order])
    cd_end, cnt_end = cum_nd[order], cum_occ[order]
    gcd = cd_end - _shift_right_one(cd_end, 0)
    gcnt = cnt_end - _shift_right_one(cnt_end, 0)
    gvalid = pos < num_groups
    # the data model's closed form (module docstring)
    want_cnt = n // n_groups + (gkey < n % n_groups).to(torch.int64)
    want_cd = torch.clamp(want_cnt, max=n_values)
    groups_ok = num_groups == min(n_groups, n)
    cd_ok = (~gvalid | (gcd == want_cd)).all()
    cnt_ok = (~gvalid | (gcnt == want_cnt)).all()
    keys_ok = (~gvalid[1:] | (gkey[1:] > gkey[:-1])).all()
    checks = torch.stack([groups_ok, cd_ok, cnt_ok, keys_ok]).tolist()
    checks = tuple(bool(c) for c in checks) + (int(num_groups),)
    if not collect:
        return checks, ()
    return checks, (torch.where(gvalid, narrow(gkey), _ONES),
                    torch.where(gvalid, narrow(gcd), 0),
                    torch.where(gvalid, narrow(gcnt), 0))


@dataclasses.dataclass
class BigDistinctResult:
    n: int
    n_groups: int
    n_values: int
    n_runs: int
    num_groups: int
    groups_ok: bool
    cd_ok: bool
    cnt_ok: bool
    keys_ok: bool
    overflow: bool            # any run's distinct pairs > partial_cap
    seconds: float
    dedup_s: float
    combine_s: float
    rows_per_s: float
    table: dict | None = None

    @property
    def all_ok(self) -> bool:
        return (self.groups_ok and self.cd_ok and self.cnt_ok
                and self.keys_ok and not self.overflow
                and self.num_groups == min(self.n_groups, self.n))


def count_distinct_big(n: int, n_groups: int = 1 << 20,
                       n_values: int = 1 << 10, run_size: int = 1 << 26,
                       partial_cap: int | None = None,
                       collect: bool = False, verbose: bool = False,
                       device: str | torch.device = "cuda"
                       ) -> BigDistinctResult:
    """COUNT(DISTINCT value) GROUP BY key over n rows generated on the
    device, out of core (module docstring); on the card unless `device`
    names another."""
    assert n % run_size == 0, (n, run_size)
    assert n < (1 << 32) and n_groups < (1 << 32) - 1
    dev = resolve_device(device)
    n_runs = n // run_size
    if partial_cap is None:
        # the data model's bound, rounded up to 128 rows
        partial_cap = min(run_size, n_groups * n_values)
        partial_cap = min(-(-partial_cap // 128) * 128, run_size)
    _build_seconds(dev)             # the kernels' build stays untimed

    t0 = _fence(dev)
    parts, m_counts = [], []
    with span("bigdistinct phase A: run dedup"):
        for rr in range(n_runs):
            klo, v, occ, m = _dedup_run(rr, run_size, n_groups, n_values,
                                        partial_cap, dev)
            parts.append((klo, v, occ))
            m_counts.append(m)
        m_host = np.array(torch.stack(m_counts).tolist())   # fence A
    overflow = bool((m_host > partial_cap).any())
    t1 = _fence(dev)
    with span("bigdistinct phase B: combine"):
        klo, v, occ = (torch.cat([p[i] for p in parts]) for i in range(3))
        del parts
        checks, planes = _combine(klo, v, occ, n, n_groups, n_values,
                                  collect)
    groups_ok, cd_ok, cnt_ok, keys_ok, num_groups = checks
    t2 = _fence(dev)
    table = None
    if collect:
        gk, gcd, gcnt = (_u32(p) for p in planes)
        keep = gk != 0xFFFFFFFF
        table = {"key": gk[keep], "count_distinct": gcd[keep],
                 "count": gcnt[keep]}
    if verbose:
        print(f"bigdistinct: {n_runs} runs dedup {t1 - t0:.2f}s "
              f"(pairs/run max {m_host.max()}), combine {t2 - t1:.2f}s")
    secs = t2 - t0
    return BigDistinctResult(
        n=n, n_groups=n_groups, n_values=n_values, n_runs=n_runs,
        num_groups=num_groups, groups_ok=groups_ok, cd_ok=cd_ok,
        cnt_ok=cnt_ok, keys_ok=keys_ok, overflow=overflow, seconds=secs,
        dedup_s=t1 - t0, combine_s=t2 - t1, rows_per_s=n / secs,
        table=table)
