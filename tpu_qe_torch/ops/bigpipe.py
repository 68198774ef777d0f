"""Out-of-core fused join -> GROUP BY, the join output never stored: the
port of tpu_qe/ops/bigpipe.py.

``join_big`` (ops/bigjoin.py) hands each bucket's joined rows to a
`consume` hook as device tensors, in key order; each bucket is partially
aggregated there (group = a hash of the join key mod G, value = the joined
right value, matched rows only) into a sentinel-padded partial table, and
one bigagg combine (ops/bigagg.py::_combine) merges the B tables with
exact u64 sums. Only G-bounded tables outlive a bucket.

Verification: matched rows are exactly the even left indices (bigjoin's
construction), so the group-count total must equal (n_l + 1) // 2; group
keys must be strictly ascending; every bucket passes bigjoin's checks.
Per-group sums are held to numpy in the tests.

The reference subtracts its first bucket's compile from the time; the
port compiles nothing, and the CLI's untimed warm-up run plays that part.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_qe_torch.bits import U64, narrow, widen
from tpu_qe_torch.hashing import murmur_fmix32, murmur_fmix32_numpy
from tpu_qe_torch.ops.aggregate import group_aggregate
from tpu_qe_torch.ops.bigagg import _combine, _const, _cut, _host_table, \
    _ONES
from tpu_qe_torch.ops.bigjoin import join_big
from tpu_qe_torch.sort.bigsort import _fence
from tpu_qe_torch.utils.profiling import span

_GSALT = 0x7F4A7C15


def _bucket_partial(klo, khi, value, matched, valid, n_groups: int,
                    partial_cap: int):
    """Aggregate one joined bucket: group = hash(join key) mod G over the
    matched rows, padded as ops/bigagg.py pads (all-ones keys, zero counts
    and sums), so that _combine merges the buckets unchanged."""
    g = narrow(widen(murmur_fmix32(klo ^ khi ^ _const(_GSALT))) % n_groups)
    mask = (matched != 0) & (valid != 0)
    res = group_aggregate(U64(g, torch.zeros_like(g)),
                          value.view(torch.uint32), aggs=("count", "sum"),
                          valid=mask)
    ok = torch.arange(partial_cap, device=klo.device) < res.num_groups
    s = res.aggs["sum"]
    return (_cut(res.key.lo, ok, _ONES), _cut(res.key.hi, ok, _ONES),
            _cut(narrow(res.aggs["count"]), ok, 0),
            _cut(s.lo, ok, 0), _cut(s.hi, ok, 0))


def group_of_join_key_numpy(key_u64: np.ndarray, n_groups: int
                            ) -> np.ndarray:
    """Numpy mirror of the bucket group hash (for oracle tests)."""
    h = ((key_u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
         ^ (key_u64 >> np.uint64(32)).astype(np.uint32)
         ^ np.uint32(_GSALT))
    return (murmur_fmix32_numpy(h).astype(np.uint64)
            % np.uint64(n_groups)).astype(np.uint32)


@dataclasses.dataclass(frozen=True)
class BigPipeResult:
    n_l: int
    n_r: int
    matched: int
    n_groups: int
    seconds: float
    rows_per_s: float
    join_ok: bool              # every bigjoin check on the device
    count_ok: bool             # group-count total == exact match count
    keys_ok: bool              # group keys strictly ascending (unique)
    compile_s: float = 0.0

    @property
    def all_ok(self) -> bool:
        return self.join_ok and self.count_ok and self.keys_ok


def join_aggregate_big(n_l: int, n_r: int, n_groups: int = 1 << 16,
                       n_buckets: int | None = None, seed: int = 7,
                       verbose: bool = False, collect: bool = False,
                       device: str | torch.device = "cuda"):
    """Fused out-of-core FK join -> GROUP BY of the joined values; on the
    card unless `device` names another.

    Runs join_big with a consume hook that partially aggregates each
    bucket on the device as it is produced, then combines the B partial
    tables. collect=True also returns the host group table dict(key,
    count, sum) (oracle tests).
    """
    partials = []

    def consume(b, bucket):
        # a bucket holds no more distinct groups than rows
        pc = min(n_groups, int(bucket["value"].shape[0]))
        partials.append(_bucket_partial(
            bucket["key"].lo, bucket["key"].hi, bucket["value"],
            bucket["matched"], bucket["valid"], n_groups, pc))

    jres = join_big(n_l, n_r, n_buckets=n_buckets, seed=seed,
                    verbose=verbose, consume=consume, device=device)
    dev = partials[0][0].device
    t1 = _fence(dev)
    with span("bigpipe combine"):
        scal, planes = _combine(tuple(partials), collect, minmax=False)
    t_combine = _fence(dev) - t1
    ng, total_cnt, _, _, ks, _ = scal
    dt = jres.seconds + t_combine
    res = BigPipeResult(
        n_l=n_l, n_r=n_r, matched=jres.matched, n_groups=ng,
        seconds=dt, rows_per_s=n_l / dt, join_ok=jres.all_ok,
        count_ok=(total_cnt == jres.matched == (n_l + 1) // 2),
        keys_ok=bool(ks), compile_s=jres.compile_s)
    if verbose:
        print(f"bigpipe: {n_l}x{n_r} -> {jres.matched} matches -> "
              f"{ng} groups in {dt:.2f}s ok={res.all_ok}")
    if collect:
        return res, _host_table(planes, minmax=False)
    return res
