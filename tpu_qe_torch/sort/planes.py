"""Lexicographic sort of rows held as u32 planes: the port's counterpart of
``jax.lax.sort(operands, num_keys=k)``.

The first `num_keys` planes are the key, most significant first, compared
as unsigned 32-bit words; every plane is permuted. The sort is stable, so
where the JAX operators append a row position as the last key to get a
stable order out of an unstable sort, the port drops that key.

Backends:

- ``radix`` (default): LSD passes of the B1 histogram, B2 scan and B3
  rank + scatter kernels, over the key planes from the least significant
  up. Two planes form the (lo, hi) words of one 64-bit B1/B3 key; a lone
  most significant plane is passed as both words (its digits lie in the
  low word). B3 carries the row permutation as its one payload and every
  other plane is gathered by it afterwards (a group's key planes before
  its passes), since B3 takes at most 8 payload planes and a gather moves
  each plane once where carrying it would move it once per pass.
  `key_bits` bounds the digits of each plane, so a 1-bit flag plane costs
  one 1-bit pass. On CPU tensors the kernels' plain twins run.
- ``torch``: the baseline, one stable ``torch.sort`` of a widened int64
  key per group, composed from the least significant group up.

Both backends sort each group with the u64 sort driver's pieces
(sort/driver.py).

With a CUDA tensor the radix backend launches the kernels or raises; it
never calls ``torch.sort``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from tpu_qe_torch.bits import digit_schedule
from tpu_qe_torch.constants import BITS_PER_PASS
from tpu_qe_torch.sort.driver import sort_radix, torch_order

BACKENDS = ("radix", "torch")


class Group(NamedTuple):
    """One 64-bit radix key: plane indices of its lo and hi words (hi None
    for a lone plane) and its (shift, bits) digits, least significant
    first."""

    lo: int
    hi: int | None
    digits: list[tuple[int, int]]


def _check_key_bits(num_keys: int, key_bits: Sequence[int] | None):
    if key_bits is None:
        return [32] * num_keys
    key_bits = list(key_bits)
    if len(key_bits) != num_keys or not all(1 <= b <= 32 for b in key_bits):
        raise ValueError(f"key_bits must hold {num_keys} values in 1..32, "
                         f"got {key_bits}")
    return key_bits


def schedule(num_keys: int,
             key_bits: Sequence[int] | None = None) -> list[Group]:
    """The radix backend's key groups, least significant first.

    Planes pair from the least significant up as (lo, hi); with an odd
    count the most significant plane stands alone. A group's digits cover
    the low key_bits of its lo plane, then of its hi plane (contiguously
    when the lo plane is full), BITS_PER_PASS bits at a time.
    """
    kb = _check_key_bits(num_keys, key_bits)
    groups = []
    for lo in range(num_keys - 1, -1, -2):
        hi = lo - 1 if lo >= 1 else None
        if hi is None:
            digits = digit_schedule(kb[lo], BITS_PER_PASS)
        elif kb[lo] == 32:
            digits = digit_schedule(32 + kb[hi], BITS_PER_PASS)
        else:
            digits = digit_schedule(kb[lo], BITS_PER_PASS) + [
                (32 + s, b) for s, b in digit_schedule(kb[hi],
                                                       BITS_PER_PASS)]
        groups.append(Group(lo, hi, digits))
    return groups


def num_passes(num_keys: int, key_bits: Sequence[int] | None = None) -> int:
    """LSD passes (B1, B2, B3 launches each) of one radix sort."""
    return sum(len(g.digits) for g in schedule(num_keys, key_bits))


def _argsort(keys, key_bits, backend):
    """LSD over the key groups with the u64 driver's sorts: B1-B3 passes
    carrying the row permutation as their one payload, or one
    ``torch.sort`` per group whose order composes the permutation."""
    n = keys[0].shape[0]
    if n >= 1 << 31:
        raise ValueError(f"{n} rows: the int32 row permutation needs n < 2^31")
    perm = (torch.arange(n, dtype=torch.int32, device=keys[0].device)
            if backend == "radix" else None)
    for i, group in enumerate(schedule(len(keys), key_bits)):
        lo = keys[group.lo] if i == 0 else keys[group.lo][perm]
        hi = lo if group.hi is None else (
            keys[group.hi] if i == 0 else keys[group.hi][perm])
        if backend == "radix":
            # handed over, so that the passes free them as they go
            planes, lo, hi, perm = [lo, hi, perm], None, None, None
            lo, hi, (perm,) = sort_radix(planes, group.digits)
        else:
            order = torch_order(lo, hi, group.digits)
            perm = order if i == 0 else perm[order]
    # the radix passes of the last (most significant) group sorted its planes
    last = {group.lo: lo, group.hi: hi} if backend == "radix" else {}
    return [last[i] if i in last else k[perm] for i, k in enumerate(keys)], perm


def argsort_planes(keys: Sequence[torch.Tensor],
                   key_bits: Sequence[int] | None = None,
                   backend: str = "radix"):
    """Stable lexicographic sort of int32 key planes (most significant
    first, unsigned; plane i compared by its low key_bits[i] bits).

    Returns (sorted key planes, perm): perm is the integer row permutation,
    so a plane p sorts as p[perm].
    """
    keys = [k.contiguous() for k in keys]
    if not keys:
        raise ValueError("argsort_planes needs at least one key plane")
    n, dev = keys[0].shape[0], keys[0].device
    for k in keys:
        if k.dtype != torch.int32 or k.dim() != 1 or k.shape[0] != n \
                or k.device != dev:
            raise ValueError("key planes must be 1-D int32 tensors of one "
                             "length on one device")
    _check_key_bits(len(keys), key_bits)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if n == 0:
        return [k.clone() for k in keys], torch.zeros(0, dtype=torch.int64,
                                                      device=dev)
    return _argsort(keys, key_bits, backend)


def sort_planes(planes: Sequence[torch.Tensor], num_keys: int,
                key_bits: Sequence[int] | None = None,
                backend: str = "radix") -> list[torch.Tensor]:
    """Rows of `planes` sorted by the first `num_keys` planes, stably: the
    counterpart of ``lax.sort(planes, num_keys=num_keys)``.

    Key planes are int32 tensors of u32 bit patterns, compared unsigned by
    their low key_bits bits; the other planes are payloads of any dtype.
    Returns every plane permuted; the inputs are not modified.
    """
    planes = list(planes)
    if not 1 <= num_keys <= len(planes):
        raise ValueError(f"num_keys={num_keys} with {len(planes)} planes")
    skeys, perm = argsort_planes(planes[:num_keys], key_bits, backend)
    return skeys + [p[perm] for p in planes[num_keys:]]
