"""Keyed shuffle primitives over a mesh of shards: the port of
tpu_qe/exchange/shuffle.py.

The JAX functions run inside ``shard_map``; these take the mesh
(exchange/mesh.py) as their first argument and per-shard tensors with a
leading shard axis, (S, n_local). Rows are int32 planes of u32 bit
patterns, and every comparison of keys, positions and ranks is unsigned
(a plane's sign bit is flipped before a signed compare), so values at and
above 2^31 order as in JAX.

  sample_splitters   all_gather a strided oversample -> global quantile
                     splitters, one (D - 1,) set that every shard shares
  route_by_splitters dest shard = #(splitters < key), counted one
                     splitter at a time into one plane (no (D-1, n)
                     temporary)
  exchange           stable local partition by dest + padded fixed-size
                     all_to_all with exact per-pair counts and overflow
                     detection. Two-tier capacity: diagonal (stay-local)
                     rows bypass the collective with full n_local
                     capacity; only off-diagonal buckets pay `capacity`,
                     which `offdiag_demand` sizes to the measured demand

Every sort here (the splitter samples, the partition by destination) is
``sort.planes.sort_planes``: the radix kernels B1-B3 on the card, or
``torch.sort`` with backend="torch". The JAX sample sorts are unstable;
a stable sort gives the same splitters, because two sampled rows that tie
on every key plane are the same values.
"""

from __future__ import annotations

import math

import torch

from tpu_qe_torch.bits import SIGN_BIT, narrow
from tpu_qe_torch.sort.planes import argsort_planes, sort_planes

AXIS = "x"            # the JAX mesh's axis name; the port's shard axis is 0
ONES = 0xFFFFFFFF


def i32(v: int) -> int:
    """A u32 value as the int32 of its bit pattern (a fill for a plane)."""
    v &= ONES
    return v - (1 << 32) if v >> 31 else v


def _u(x: torch.Tensor) -> torch.Tensor:
    """int32 plane whose signed order is the plane's u32 order."""
    return x ^ SIGN_BIT


def cmp_gt(lo_a, hi_a, lo_b, hi_b):
    """u64 pair comparison a > b, unsigned."""
    ha, hb = _u(hi_a), _u(hi_b)
    return (ha > hb) | ((ha == hb) & (_u(lo_a) > _u(lo_b)))


def _sample_idx(n_local: int, samples_per_dev: int, n_valid, shards: int,
                device) -> torch.Tensor:
    """(S, samples_per_dev) int64 row indices of the strided oversample."""
    k = torch.arange(samples_per_dev, device=device)
    if n_valid is None:
        stride = max(n_local // samples_per_dev, 1)
        return ((k * stride) % n_local).expand(shards, samples_per_dev)
    nv = torch.clamp(n_valid.to(torch.int64), min=1)[:, None]
    stride = torch.clamp(nv // samples_per_dev, min=1)
    return (k[None] * stride) % nv


def _splitters(mesh, planes, n_dev, samples_per_dev, n_valid, backend):
    """Gather every shard's samples of `planes` (major first), sort them,
    and take the D-quantiles: one (D - 1,) tensor per plane."""
    shards, n_local = planes[0].shape
    idx = _sample_idx(n_local, samples_per_dev, n_valid, shards,
                      planes[0].device)
    # every shard sees the same gathered samples: sort them once (empty
    # shards sample the all-ones pad, so every splitter is the pad)
    g = [mesh.all_gather(p.gather(1, idx) if n_local
                         else torch.full(idx.shape, -1, dtype=p.dtype,
                                         device=p.device))[0]
         for p in planes]
    g = sort_planes(g, len(g), backend=backend)
    total = n_dev * samples_per_dev
    sp_idx = (torch.arange(1, n_dev, device=g[0].device) * total) // n_dev
    return [p[sp_idx] for p in g]


def sample_splitters(mesh, lo, hi, n_dev: int, samples_per_dev: int,
                     n_valid=None, backend: str = "radix"):
    """Global D-quantile splitters from a strided per-shard oversample.

    n_valid (optional, (S,)): sample only the first n_valid rows of each
    shard, for arrays that carry a valid prefix followed by padding (e.g.
    partial aggregation results). Returns (sp_lo, sp_hi), (D - 1,) each.
    """
    sp_hi, sp_lo = _splitters(mesh, [hi, lo], n_dev, samples_per_dev,
                              n_valid, backend)
    return sp_lo, sp_hi


def _count_above(rows_gt, n_splitters: int, like: torch.Tensor):
    """dest = sum over splitters j of rows_gt(j), as an int32 plane."""
    dest = torch.zeros(like.shape, dtype=torch.int32, device=like.device)
    for j in range(n_splitters):
        dest += rows_gt(j).to(torch.int32)
    return dest


def route_by_splitters(lo, hi, sp_lo, sp_hi):
    """dest shard = number of splitters strictly below the key."""
    ulo, uhi, slo, shi = _u(lo), _u(hi), _u(sp_lo), _u(sp_hi)
    return _count_above(
        lambda j: (uhi > shi[j]) | ((uhi == shi[j]) & (ulo > slo[j])),
        sp_lo.shape[0], lo)


def sample_splitters_pos(mesh, lo, hi, pos, n_dev: int,
                         samples_per_dev: int, backend: str = "radix"):
    """(key, position) splitters: heavy-key splitting with stability.

    With the global position as the least significant key, quantiles fall
    within runs of equal keys, so a hot key splits across shards; global
    order holds because duplicates are position-ordered across the shard
    range. Returns (sp_lo, sp_hi, sp_pos), (D - 1,) each.
    """
    sp_hi, sp_lo, sp_pos = _splitters(mesh, [hi, lo, pos], n_dev,
                                      samples_per_dev, None, backend)
    return sp_lo, sp_hi, sp_pos


def sample_splitters_multi(mesh, planes, n_dev: int, samples_per_dev: int,
                           backend: str = "radix"):
    """Lexicographic splitters over (S, n_local) u32 key planes listed
    major to minor (e.g. [key_hi, key_lo, order_bits, position]); returns
    one (D - 1,) splitter tensor per plane."""
    return _splitters(mesh, list(planes), n_dev, samples_per_dev, None,
                      backend)


def route_by_splitters_multi(planes, sps):
    """dest = number of splitters lexicographically strictly below the
    row, over matched major -> minor plane lists."""
    up = [_u(p) for p in reversed(planes)]
    us = [_u(s) for s in reversed(sps)]

    def gt(j):
        out = torch.zeros(planes[0].shape, dtype=torch.bool,
                          device=planes[0].device)
        for p, sp in zip(up, us):
            out = (p > sp[j]) | ((p == sp[j]) & out)
        return out

    return _count_above(gt, sps[0].shape[0], planes[0])


def route_by_splitters_pos(lo, hi, pos, sp_lo, sp_hi, sp_pos):
    """dest = number of (key, position) splitters strictly below the row."""
    ulo, uhi, upos = _u(lo), _u(hi), _u(pos)
    slo, shi, spos = _u(sp_lo), _u(sp_hi), _u(sp_pos)

    def gt(j):
        k_gt = (uhi > shi[j]) | ((uhi == shi[j]) & (ulo > slo[j]))
        k_eq = (ulo == slo[j]) & (uhi == shi[j])
        return k_gt | (k_eq & (upos > spos[j]))

    return _count_above(gt, sp_lo.shape[0], lo)


def _dest_key(dest: torch.Tensor, n_dev: int):
    """(shard, dest) packed into one int32 plane over the flattened shards,
    and its width in bits."""
    shards = dest.shape[0]
    shard = torch.arange(shards, dtype=torch.int32,
                         device=dest.device)[:, None]
    key = (shard * n_dev + dest).reshape(-1)
    return key, max((shards * n_dev - 1).bit_length(), 1)


def _dest_counts(dest: torch.Tensor, n_dev: int) -> torch.Tensor:
    """(S, D) int64 rows of each shard bound for each destination."""
    key, _ = _dest_key(dest, n_dev)
    return torch.bincount(key, minlength=dest.shape[0] * n_dev).reshape(
        dest.shape[0], n_dev)


def _partition_by_dest(dest, cols, n_dev: int, backend: str = "radix"):
    """Stable partition of each shard's rows by destination.

    Returns (cols_s, dest_s, counts, offsets): the columns and dest in
    partitioned order ((S, n_local) each), and the (S, D) int64 row counts
    and first rows per destination. One stable sort of the packed (shard,
    dest) plane at its real width (one radix pass for up to 256 (shard,
    dest) pairs) gives the JAX package's order: destination, then row.
    """
    shards, n_local = dest.shape
    key, bits = _dest_key(dest, n_dev)
    (skey,), perm = argsort_planes([key], [bits], backend)
    cols_s = [c.reshape(-1)[perm].reshape(shards, n_local) for c in cols]
    dest_s = (skey % n_dev).reshape(shards, n_local)
    # the sorted keys' run boundaries (a bincount's atomics on 64 bins
    # contend: on an H100 it took 9 % of a 2^26-row sort of 8 shards)
    bounds = torch.searchsorted(skey, torch.arange(
        shards * n_dev + 1, dtype=torch.int32, device=dest.device))
    counts = (bounds[1:] - bounds[:-1]).reshape(shards, n_dev)
    offsets = torch.cumsum(counts, 1) - counts
    return cols_s, dest_s, counts, offsets


def pow2_capacity(demand: int, slack: float = 1.05) -> int:
    """Demand -> static exchange capacity: slack margin + next power of
    two, the one rule of every plan-then-execute caller."""
    need = max(math.ceil(demand * slack), 16)
    return 1 << (need - 1).bit_length()


def offdiag_demand(mesh, dest, n_dev: int) -> torch.Tensor:
    """Max off-diagonal (src, dst) bucket size across the mesh, (S,) int64
    (the same value on every shard).

    The planning half of demand-sized exchange: read it back and size
    `capacity` for the real exchange to the measured demand. Diagonal
    (dest == own rank) rows never enter the all_to_all.
    """
    counts = _dest_counts(dest, n_dev)
    diag = (torch.arange(n_dev, device=dest.device)[None]
            == mesh.ranks()[:, None])
    return mesh.pmax(counts.masked_fill(diag, 0).amax(1))


def exchange(mesh, dest, cols, pad_values, n_dev: int, capacity: int,
             backend: str = "radix"):
    """Move rows to their dest shard: local keep + padded all_to_all.

    Rows whose destination is their own shard never enter the all_to_all:
    they stay in a local tail block with full n_local capacity. Only
    off-diagonal (src != dst) buckets consume `capacity`.

    Args:
      dest: (S, n_local) int32 destination shard per row.
      cols: (S, n_local) int32 planes to move, carried through one stable
        partition so order within a destination is preserved.
      pad_values: per-column u32 fill for exchange padding.
    Returns:
      (recv_cols, recv_flag, recv_rank, recv_counts, overflow):
        recv_cols: (S, D * capacity + n_local) planes: D off-diagonal
          blocks grouped by source rank (the own rank's block is all
          padding), then the n_local tail of the rows that stayed local;
        recv_flag: int32, 1 where the slot is padding;
        recv_rank: int32 plane of the u32 stability rank, strictly
          increasing over (source rank, order within the source);
        recv_counts: (S, D) int64 real rows received from each source
          (the own rank's local rows included);
        overflow: (S,) int64, 1 if any off-diagonal (src, dst) run
          exceeded capacity (counts stay exact, so truncation shows).
    """
    shards, n_local = dest.shape
    dev = dest.device
    cols_s, _, counts, offsets = _partition_by_dest(dest, cols, n_dev,
                                                    backend)
    me = mesh.ranks()
    diag = torch.arange(n_dev, device=dev)[None] == me[:, None]
    send_counts = counts.masked_fill(diag, 0)
    base = torch.arange(shards, device=dev)[:, None] * n_local

    # pack: block (s, d) gathers rows offsets[s, d] + [0, capacity) of
    # shard s, masked past send_counts[s, d]; one index for every column
    j = torch.arange(capacity, device=dev)
    in_run = j < send_counts[:, :, None]                  # (S, D, cap)
    pack_idx = torch.clamp(offsets[:, :, None] + j, max=n_local - 1)
    pack_idx = (pack_idx + base[:, :, None]).reshape(-1)
    t = torch.arange(n_local, device=dev)
    tail_off = offsets.gather(1, me[:, None])
    tail_cnt = counts.gather(1, me[:, None])
    in_tail = t < tail_cnt                                # (S, n_local)
    tail_idx = (torch.clamp(tail_off + t, max=n_local - 1) + base).reshape(
        -1)
    recv_cols = []
    for c, fill in zip(cols_s, pad_values):
        flat = c.reshape(-1)
        # an empty plane reads as the pad (the JAX gather's clip mode)
        packed = (torch.where(in_run, flat[pack_idx].reshape(
            shards, n_dev, capacity), i32(fill)) if n_local
            else torch.full(in_run.shape, i32(fill), dtype=c.dtype,
                            device=dev))
        tail = torch.where(in_tail, flat[tail_idx].reshape(shards, n_local),
                           i32(fill))
        recv_cols.append(torch.cat(
            [mesh.all_to_all(packed).reshape(shards, -1), tail], 1))
    del pack_idx, in_run
    recv_counts = mesh.all_to_all(counts[:, :, None])[:, :, 0]
    # a received block holds the sender's send_counts[j, s] real rows: the
    # count from j, none from the own rank (whose rows are in the tail)
    recv_send = recv_counts.masked_fill(diag, 0)
    recv_flag = torch.cat([
        (j >= recv_send[:, :, None]).reshape(shards, -1),
        ~in_tail], 1).to(torch.int32)
    # stability rank: source-major, order within a source kept; the local
    # tail's source is the own rank. Stride M keeps sources disjoint.
    m_stride = max(capacity, n_local)
    off_pos = torch.arange(n_dev * capacity, device=dev)
    off_rank = narrow((off_pos // capacity) * m_stride + off_pos % capacity)
    tail_rank = narrow(me[:, None] * m_stride + t)
    recv_rank = torch.cat([off_rank.expand(shards, -1), tail_rank], 1)
    overflow = (mesh.pmax(send_counts.amax(1)) > capacity).to(torch.int64)
    return recv_cols, recv_flag, recv_rank, recv_counts, overflow
