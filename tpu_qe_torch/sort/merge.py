"""Bitonic merge of pre-sorted runs (the overlapped distributed sort's
tail): the port of tpu_qe/sort/merge.py.

Merging two sorted runs costs log2(2m) compare-exchange stages instead of
a re-sort. Columns are int32 planes of u32 bit patterns, ordered by
(hi, lo, rank) compared unsigned; payload planes ride along.

The JAX network runs its stages down to a stride of 256 and then sorts
aligned 256-row windows with ``lax.sort`` (a TPU layout constraint). The
port runs the network's own stages to the end (strides 256 down to 1,
each a ``torch.where`` over a reshaped view), which gives the same rows:
in every use (hi, lo, rank) is unique, so the merged order is unique.

Runs may carry leading batch dimensions (one row of runs per shard, as
exchange/dsort.py hands them over): every stage works along the last
dimension.
"""

from __future__ import annotations

import torch

from tpu_qe_torch.bits import SIGN_BIT


def _lex_le(ah, al, ar, bh, bl, br):
    """(ah, al, ar) <= (bh, bl, br) over planes whose signed order is the
    u32 order (sign bit flipped)."""
    return (ah < bh) | ((ah == bh) & ((al < bl) | ((al == bl) & (ar <= br))))


def lex_le3(a, b):
    """Lexicographic a <= b over (hi, lo, rank) column triples of int32
    planes, each compared as u32."""
    return _lex_le(*(x ^ SIGN_BIT for x in a[:3]), *(x ^ SIGN_BIT
                                                      for x in b[:3]))


def bitonic_merge_cols(A, B):
    """Merge two column sets, each ascending by (hi, lo, rank), into one.

    Columns are [hi, lo, rank, *payloads] (the first min(3, len) are the
    key); both runs have the same power-of-two length along the last
    dimension. concat(A, reverse(B)) is bitonic, and half-cleaner stages
    at strides m, m/2, ..., 1 sort it.
    """
    m = A[0].shape[-1]
    assert m == B[0].shape[-1] and m >= 1 and (m & (m - 1)) == 0, (
        m, B[0].shape)
    nk = min(3, len(A))
    cols = [torch.cat([a, b.flip(-1)], -1) for a, b in zip(A, B)]
    # key planes in signed-order form for the stages, flipped back after
    cols = [c ^ SIGN_BIT if i < nk else c for i, c in enumerate(cols)]
    batch = cols[0].shape[:-1]
    total = 2 * m
    s = m
    while s >= 1:
        parts = [c.reshape(*batch, total // (2 * s), 2, s) for c in cols]
        a = [p[..., 0, :] for p in parts]
        b = [p[..., 1, :] for p in parts]
        ka = a[:nk] + [a[0]] * (3 - nk)
        kb = b[:nk] + [b[0]] * (3 - nk)
        a_le_b = _lex_le(*ka, *kb)
        cols = [torch.stack([torch.where(a_le_b, x, y),
                             torch.where(a_le_b, y, x)], -2)
                .reshape(*batch, total) for x, y in zip(a, b)]
        s //= 2
    return [c ^ SIGN_BIT if i < nk else c for i, c in enumerate(cols)]


def merge_tree(runs):
    """Merge a power-of-two list of sorted runs into one sorted run."""
    assert len(runs) & (len(runs) - 1) == 0, len(runs)
    while len(runs) > 1:
        runs = [bitonic_merge_cols(runs[i], runs[i + 1])
                for i in range(0, len(runs), 2)]
    return runs[0]
