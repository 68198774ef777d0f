"""Two-level blocked inclusive scan for segmented monoids: the port of
tpu_qe/ops/segscan.py.

``scan_assoc`` folds an associative combine in the JAX module's order:
rows cut into (B, C) blocks with C = BLOCK = 1024, a Hillis-Steele scan
along each block, an exclusive scan of the block summaries, and one
combine of each block's carry into its rows. Keeping that order makes
float sums associate as in JAX, so they come out bit-identical. Plain
torch: JAX runs this outside Pallas too.

The unsegmented integer wrappers (``cumsum_u32``, ``cummax_u32``,
``cumsum_u64_pair``) give the same bits in any association order, so they
run on the widened int64 values as one ``torch.cumsum`` (exact, since
n < 2^31 rows of values below 2^32 sum below 2^63) or ``cummax_int64``.
Planes are int32 tensors of u32 bit patterns in and out.
"""

from __future__ import annotations

import torch

from tpu_qe_torch.bits import narrow, widen

BLOCK = 1024


def _shifted(state, idents, stride: int, axis: int):
    outs = []
    for x, i in zip(state, idents):
        pad_shape = list(x.shape)
        pad_shape[axis] = stride
        pad = torch.full(pad_shape, i, dtype=x.dtype, device=x.device)
        body = x[:-stride] if axis == 0 else x[:, :-stride]
        outs.append(torch.cat([pad, body], dim=axis))
    return tuple(outs)


def _strided(combine, idents, state, length: int, axis: int):
    """Flat Hillis-Steele inclusive scan along `axis` (0 or minor = 1)."""
    stride = 1
    while stride < length:
        state = combine(_shifted(state, idents, stride, axis), state)
        stride *= 2
    return state


def scan_assoc(combine, idents, state, block: int = BLOCK):
    """Inclusive scan of a tuple of equal-length 1-D tensors under
    `combine((a0, a1, ...), (b0, b1, ...))`, `a` the earlier prefix;
    `idents` are per-plane left-identity scalars."""
    state = tuple(state)
    n = state[0].shape[0]
    if n <= 4 * block:
        return _strided(combine, idents, state, n, axis=0)
    nb = -(-n // block)
    npad = nb * block
    if npad > n:
        state = tuple(
            torch.cat([x, torch.full((npad - n,), i, dtype=x.dtype,
                                     device=x.device)])
            for x, i in zip(state, idents))
    state = tuple(x.reshape(nb, block) for x in state)
    state = _strided(combine, idents, state, block, axis=1)
    # exclusive cross-block carry: shift summaries down one block, scan
    sums = tuple(x[:, -1] for x in state)
    sums = _shifted(sums, idents, 1, axis=0)
    carry = _strided(combine, idents, sums, nb, axis=0)
    carry = tuple(c[:, None].expand(nb, block) for c in carry)
    state = combine(carry, state)
    return tuple(x.reshape(npad)[:n] for x in state)


def cummax_int64(x: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """Inclusive running max of a 1-D int64 tensor, in two levels:
    ``torch.cummax`` along the rows of a (B, block) view, then over the
    block maxima (recursively), combined with one maximum. A 1-D
    ``torch.cummax`` on a CUDA tensor runs in a single thread block: on an
    H100 it took about 0.6 s over 2e8 rows; the row-wise scans run in
    parallel."""
    n = x.shape[0]
    if n <= block:
        return torch.cummax(x, 0).values if n else x.clone()
    nb = -(-n // block)
    low = torch.iinfo(torch.int64).min
    if nb * block > n:
        x = torch.cat([x, x.new_full((nb * block - n,), low)])
    rows = torch.cummax(x.reshape(nb, block), 1).values
    carry = cummax_int64(rows[:, -1].contiguous(), block)
    carry = torch.cat([carry.new_full((1,), low), carry[:-1]])
    return torch.maximum(rows, carry[:, None]).reshape(-1)[:n]


def cumsum_u32(v: torch.Tensor) -> torch.Tensor:
    """Inclusive wrapping u32 cumsum of an int32 plane."""
    return narrow(torch.cumsum(widen(v), 0))


def cummax_u32(v: torch.Tensor) -> torch.Tensor:
    """Inclusive running max of an int32 plane, compared unsigned."""
    return narrow(cummax_int64(widen(v)))


def cumsum_u64_pair(v: torch.Tensor, vhi: torch.Tensor | None = None):
    """Inclusive exact u64 prefix sum of u32 values as (lo, hi) int32
    planes.

    vhi: optional hi words of each added value. With vhi = 0xFFFFFFFF on
    negative rows (sign extension), int32 values sum exactly as signed
    values in two's complement mod 2^64.
    """
    x = widen(v)
    if vhi is not None:
        x = x + vhi.to(torch.int64) * (1 << 32)
    s = torch.cumsum(x, 0)
    return narrow(s), narrow(s >> 32)
