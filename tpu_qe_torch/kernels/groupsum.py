"""GROUP BY's counts and exact integer sums on the card: E2 (csrc/groupsum.cu).

The port's own kernel; it replaces no TPU kernel. Over rows sorted by
(invalid flag, key) it finds the groups from the key words and, in one
pass over the rows, gathers each value by the sort permutation into an
exact u64 sum per group: u32 values zero-extended, i32 values
sign-extended (the two's-complement sum mod 2^64). A group is every row
after the previous group end up to its own; invalid rows, sorted to the
tail, end none.

Its plain twin, ``segment_sums_plain``, is the chain that
ops/aggregate.py ran before: a gather of each column by the permutation,
an int64 prefix sum (``cumsum_u64_pair``) and borrow differences at the
group-end rows, which ``stable_partition`` (or, under ``max_groups``,
``_extract``'s binary search) brings to the front.

The kernel takes up to ``K_MAX`` columns a launch; more take one launch
per chunk, each of which writes the same ends, counts and keys.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from tpu_qe_torch.bits import U64
from tpu_qe_torch.kernels import LAUNCHES, check, library, stream_of

K_MAX = 8


class GroupSums(NamedTuple):
    """Per group g below the capacity (max_groups, or n rows), in key
    order: its last sorted row, its rows, its key and each column's exact
    u64 sum. Entries from num_groups on are undefined."""

    end: torch.Tensor         # int64
    count: torch.Tensor       # int64
    key: U64
    sums: list                # U64 a column
    num_groups: torch.Tensor  # 0-d int64, exact even past the capacity


def _check_args(slo, shi, sinvalid, perm, cols, signed, max_groups):
    n, dev = slo.shape[0] if slo.dim() == 1 else -1, slo.device
    if perm.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"perm must be int32 or int64, got {perm.dtype}")
    tensors = [("slo", slo, torch.int32), ("shi", shi, torch.int32),
               ("perm", perm, perm.dtype)]
    if sinvalid is not None:
        tensors.append(("sinvalid", sinvalid, torch.bool))
    tensors += [("cols", c, torch.int32) for c in cols]
    for name, t, dtype in tensors:
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous() or \
                t.shape[0] != n:
            raise ValueError(f"{name} must be a contiguous ({n},) {dtype} "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, slo on {dev}")
    if len(signed) != len(cols):
        raise ValueError(f"{len(signed)} sign flags for {len(cols)} columns")
    if max_groups is not None and max_groups < 1:
        raise ValueError(f"max_groups must be at least 1, got {max_groups}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def segment_sums_plain(slo: torch.Tensor, shi: torch.Tensor,
                       sinvalid: torch.Tensor | None, perm: torch.Tensor,
                       cols: Sequence[torch.Tensor], signed: Sequence[bool],
                       max_groups: int | None = None) -> GroupSums:
    """Plain twin of segment_sums: prefix sums differenced at the ends."""
    from tpu_qe_torch.ops.aggregate import (_boundaries, _diff_u64,
                                            _extract, _shift_right_one)
    from tpu_qe_torch.ops.filter import stable_partition
    from tpu_qe_torch.ops.segscan import cumsum_u64_pair

    _, is_end = _boundaries(slo, shi, sinvalid)
    prefixes = []
    for v, sgn in zip(cols, signed):
        v = v[perm]
        # sign extension into the hi plane: the exact signed sum
        prefixes.append(cumsum_u64_pair(
            v, torch.where(v < 0, -1, 0).to(torch.int32) if sgn else None))
    if max_groups is not None:
        num_groups, _, end, _, pos_end = _extract(is_end, max_groups)
    else:
        end = stable_partition(is_end)
        pos_end = end + 1
        num_groups = is_end.sum(dtype=torch.int64)
    count = pos_end - _shift_right_one(pos_end, 0)
    sums = [_diff_u64(lo[end], hi[end]) for lo, hi in prefixes]
    return GroupSums(end, count, U64(slo[end], shi[end]), sums, num_groups)


def segment_sums(slo: torch.Tensor, shi: torch.Tensor,
                 sinvalid: torch.Tensor | None, perm: torch.Tensor,
                 cols: Sequence[torch.Tensor], signed: Sequence[bool],
                 max_groups: int | None = None) -> GroupSums:
    """Counts, keys and exact u64 sums of the groups of key-sorted rows.

    slo, shi: (n,) int32 key words sorted by (invalid flag, key);
    sinvalid: the sorted (n,) bool invalid flags, or None; perm: the
    (n,) int32 or int64 permutation that sorted the rows, every entry in
    [0, n) (the kernel reads what it is given); cols: (n,) int32 bit planes of
    value columns in their original order, signed[j] True where column j
    is i32. Outputs hold max_groups groups, or n without it. CPU tensors
    take the plain twin; CUDA tensors take the kernel, one launch per
    K_MAX columns (at least one), and no read of the device.
    """
    cols, signed = list(cols), list(signed)
    dev = _check_args(slo, shi, sinvalid, perm, cols, signed, max_groups)
    if dev.type == "cpu":
        return segment_sums_plain(slo, shi, sinvalid, perm, cols, signed,
                                  max_groups)
    n = slo.shape[0]
    cap = n if max_groups is None else max_groups
    end = torch.empty(cap, dtype=torch.int64, device=dev)
    count = torch.empty_like(end)
    key = U64(torch.empty(cap, dtype=torch.int32, device=dev),
              torch.empty(cap, dtype=torch.int32, device=dev))
    sums = [U64(torch.empty_like(key.lo), torch.empty_like(key.lo))
            for _ in cols]
    num_groups = torch.empty((), dtype=torch.int64, device=dev)
    if n == 0:
        return GroupSums(end, count, key, sums, num_groups.zero_())
    lib = library()
    for c0 in range(0, max(len(cols), 1), K_MAX):
        chunk = range(c0, min(c0 + K_MAX, len(cols)))
        k = len(chunk)
        ptrs = (ctypes.c_void_p * max(k, 1))(*[cols[j].data_ptr()
                                                for j in chunk])
        lo = (ctypes.c_void_p * max(k, 1))(*[sums[j].lo.data_ptr()
                                              for j in chunk])
        hi = (ctypes.c_void_p * max(k, 1))(*[sums[j].hi.data_ptr()
                                              for j in chunk])
        sign = sum(1 << (j - c0) for j in chunk if signed[j])
        scratch = torch.empty(lib.tq_group_sums_scratch(n, k),
                              dtype=torch.int64, device=dev)
        check(lib, lib.tq_group_sums(
            slo.data_ptr(), shi.data_ptr(),
            None if sinvalid is None else sinvalid.data_ptr(),
            perm.data_ptr(), perm.element_size(), n, ptrs, sign, k, cap,
            end.data_ptr(), count.data_ptr(), key.lo.data_ptr(),
            key.hi.data_ptr(), lo, hi, num_groups.data_ptr(),
            scratch.data_ptr(), dev.index, stream_of(slo)), "group_sums")
        LAUNCHES["group_sums"] += 1
    return GroupSums(end, count, key, sums, num_groups)
