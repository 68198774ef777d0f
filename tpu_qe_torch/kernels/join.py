"""The inner equi-join's index on the card: E3 (csrc/join.cu).

The port's own kernel; it replaces no TPU kernel (the JAX package's join
is plain jnp). Two steps:

- ``join_index``: for each left key, its first matching row in a sorted
  right key (the insertion point where none matches) and its match count,
  as int32, with two exact totals on the device: the output rows (the sum
  of the counts) and the left rows whose count is not 1. Where the output
  rows equal the left rows and no count differs from 1, every left row
  matched once: the join is the identity on the left and the right rows
  are ``start``.
- ``join_emit``: the output slots of the general case, (left row, sorted
  right row) in left order and, within a left row, in sorted right order,
  below a budget, from the exclusive scan of the counts (B2's kernel,
  launched as the emit's first step and counted under ``join_emit``).

Their plain twins, ``join_index_plain`` and ``join_emit_plain``, are the
chain ops/join.py ran before: ``join_sorted``'s two searches, the counts
and their totals, then ``expand_ranges``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_qe_torch.bits import U64
from tpu_qe_torch.kernels import (LAUNCHES, check, library, require_planes,
                                  stream_of)

_INT32_ROWS = (1 << 31) - 1     # rows and slots E3 takes: fewer than this


class JoinIndex(NamedTuple):
    """Per left row: its first matching sorted right row (the insertion
    point where none matches) and its match count; and the exact totals."""

    start: torch.Tensor    # (n,) int32
    count: torch.Tensor    # (n,) int32
    totals: torch.Tensor   # (2,) int64: output rows, rows with count != 1

    @property
    def num_out(self) -> torch.Tensor:
        return self.totals[0]


def _key_device(name: str, key: U64) -> torch.device:
    dev = require_planes(key.lo, key.hi)
    if key.lo.shape[0] >= _INT32_ROWS:
        raise ValueError(f"{name} key has {key.lo.shape[0]} rows; E3 takes "
                         "under 2^31 - 1")
    return dev


def join_index_plain(left_key: U64, right_key_sorted: U64) -> JoinIndex:
    """Plain twin of join_index: join_sorted's two searches, the counts and
    their totals."""
    from tpu_qe_torch.ops.join import join_sorted

    r = join_sorted(left_key, right_key_sorted)
    c = r.end - r.start
    totals = torch.stack([c.sum(), (c != 1).sum()])
    return JoinIndex(r.start.to(torch.int32), c.to(torch.int32), totals)


def join_index(left_key: U64, right_key_sorted: U64) -> JoinIndex:
    """Each left key's first match and match count in a right key sorted
    ascending as u64, with the totals. CPU tensors take the plain twin;
    CUDA tensors take the kernel, one launch, and no read of the device."""
    dev = _key_device("left", left_key)
    if _key_device("right", right_key_sorted) != dev:
        raise ValueError("left and right keys lie on two devices")
    if dev.type == "cpu":
        return join_index_plain(left_key, right_key_sorted)
    n, m = left_key.lo.shape[0], right_key_sorted.lo.shape[0]
    start = torch.empty(n, dtype=torch.int32, device=dev)
    count = torch.empty_like(start)
    totals = torch.empty(2, dtype=torch.int64, device=dev)
    lib = library()
    check(lib, lib.tq_join_probe(
        left_key.lo.data_ptr(), left_key.hi.data_ptr(), n,
        right_key_sorted.lo.data_ptr(), right_key_sorted.hi.data_ptr(), m,
        start.data_ptr(), count.data_ptr(), totals.data_ptr(), dev.index,
        stream_of(start)), "join_probe")
    LAUNCHES["join_probe"] += 1
    return JoinIndex(start, count, totals)


def join_emit_plain(index: JoinIndex, out_budget: int):
    """Plain twin of join_emit: expand_ranges over [start, start + count)."""
    from tpu_qe_torch.ops.join import SortedJoinIndex, expand_ranges

    s = index.start.to(torch.int64)
    li, ri, _, _ = expand_ranges(
        SortedJoinIndex(s, s + index.count.to(torch.int64)), out_budget)
    return li, ri


def join_emit(index: JoinIndex, out_budget: int):
    """(left_index, right_index) of the first out_budget output slots:
    slot offsets[i] + k holds (i, start[i] + k) for k < count[i]. Slots
    from index.num_out on are undefined. CPU tensors take the plain twin
    (int64 indices, its own limits); CUDA tensors take B2's scan of the
    counts and the kernel (int32 indices, 1 <= out_budget < 2^31 - 1), and no
    read of the device."""
    from tpu_qe_torch.kernels.scan import launch_exclusive_scan

    start, count, totals = index
    dev, n = require_planes(start, count), start.shape[0]
    if totals.dtype != torch.int64 or tuple(totals.shape) != (2,) \
            or totals.device != dev:
        raise ValueError("totals must be two int64 values beside start")
    if dev.type == "cpu":
        return join_emit_plain(index, out_budget)
    if not 1 <= out_budget < _INT32_ROWS:
        raise ValueError(f"bad out_budget {out_budget}: E3 emits 1 to 2^31 - 2"
                         " slots")
    offsets = launch_exclusive_scan(count)
    li = torch.empty(out_budget, dtype=torch.int32, device=dev)
    ri = torch.empty_like(li)
    lib = library()
    check(lib, lib.tq_join_emit(
        start.data_ptr(), count.data_ptr(), offsets.data_ptr(), n,
        totals.data_ptr(), out_budget, li.data_ptr(), ri.data_ptr(),
        dev.index, stream_of(start)), "join_emit")
    LAUNCHES["join_emit"] += 1
    return li, ri
