"""SQL set operations over u64 key columns, UNION / INTERSECT / EXCEPT
with DISTINCT semantics: the port of tpu_qe/ops/setops.py.

Both sides are concatenated (A rows, then B rows) and sorted by key. The
JAX package sorts by (key, side); because A rows precede B rows in the
input, the stable sort by key alone gives that order, so the side flag
rides as a payload. Each key run's membership follows from one cumulative
count of B rows, and two stable partitions emit the qualifying keys with
each side's multiplicity.
"""

from __future__ import annotations

import torch

from tpu_qe_torch.bits import U64
from tpu_qe_torch.ops.aggregate import _boundaries, _shift_right_one
from tpu_qe_torch.ops.filter import stable_partition
from tpu_qe_torch.sort.planes import argsort_planes

_OPS = ("union", "intersect", "except")


def _qualifies(op: str, in_a, in_b):
    if op == "union":
        return in_a | in_b
    if op == "intersect":
        return in_a & in_b
    return in_a & ~in_b  # except


def set_op(a: U64, b: U64, op: str, backend: str = "radix"):
    """DISTINCT-semantics set operation over two u64 key columns.

    Returns (keys: U64 ascending, padded with all-ones; count_a; count_b;
    num): the first `num` rows are the result keys with each side's
    multiplicity (int64, zero in the padding)."""
    if op not in _OPS:
        raise ValueError(f"op must be one of {_OPS}, got {op!r}")
    n_a, n_b = a.lo.shape[0], b.lo.shape[0]
    n = n_a + n_b
    dev = a.lo.device
    if n == 0:
        # the key-end partition below reads one row past an empty stream
        # (the JAX gathers clamp it away): the empty answer directly
        z32 = torch.zeros(0, dtype=torch.int32, device=dev)
        z64 = torch.zeros(0, dtype=torch.int64, device=dev)
        return (U64(z32, z32), z64, z64,
                torch.zeros((), dtype=torch.int64, device=dev))
    (shi, slo), perm = argsort_planes([torch.cat([a.hi, b.hi]),
                                       torch.cat([a.lo, b.lo])],
                                      backend=backend)
    pos = torch.arange(n, device=dev)
    _, key_end = _boundaries(slo, shi, None)
    cum_b = torch.cumsum((perm >= n_a).to(torch.int64), 0)  # B rows so far
    # key-end rows with (total position, B count): per-key counts follow
    # from consecutive differences
    order = stable_partition(key_end)
    pe = order + 1
    cnt = pe - _shift_right_one(pe, 0)
    cb_end = cum_b[order]
    cb = cb_end - _shift_right_one(cb_end, 0)
    ca = cnt - cb
    n_keys = key_end.sum(dtype=torch.int64)
    keep = (pos < n_keys) & _qualifies(op, ca > 0, cb > 0)
    num = keep.sum(dtype=torch.int64)
    order2 = stable_partition(keep)
    valid = pos < num
    rlo, rhi = slo[order], shi[order]
    return (U64(torch.where(valid, rlo[order2], -1),
                torch.where(valid, rhi[order2], -1)),
            torch.where(valid, ca[order2], 0),
            torch.where(valid, cb[order2], 0), num)
