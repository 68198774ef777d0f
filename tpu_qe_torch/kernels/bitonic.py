"""Bitonic chunk sort by the u64 key (hi, lo), carrying payload planes (B5).

Port of tpu_qe/kernels/bitonic.py::sort_chunks as CUDA kernels in
csrc/bitonic.cu. Same network, same per-pair rule: the pair (a at the lower
index, b at +j) exchanges iff (a > b) differs from "descending", where
descending = (index in chunk & k) != 0, so equal keys exchange in
descending regions. Keys and payloads therefore come out bit-identical to
the JAX kernel, ties included. The sort is not stable.

The plain twin runs the same network in torch, one reshape and select per
stage; torch.sort would order tied payloads differently.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_qe_torch.bits import widen
from tpu_qe_torch.kernels import LAUNCHES, check, library, stream_of

LANES = 128            # the JAX kernel's chunk is rows * 128 lanes
MAX_PAYLOADS = 8       # as B3's scatter
_MAX_PLANES = 2 + MAX_PAYLOADS


def _check_args(planes, rows: int) -> torch.device:
    if len(planes) > _MAX_PLANES:
        raise ValueError(f"at most {MAX_PAYLOADS} payload planes, got "
                         f"{len(planes) - 2}")
    shape, dev = planes[0].shape, planes[0].device
    for t in planes:
        if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError("expected contiguous (nb, width) int32 planes, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.shape != shape or t.device != dev:
            raise ValueError("planes differ in shape or device")
    width = shape[1]
    if width != rows * LANES:
        raise ValueError(f"chunk width {width} != rows * {LANES} "
                         f"({rows} rows)")
    if width < 1 or width & (width - 1):
        raise ValueError(f"chunk width must be a power of two, got {width}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _stage_plain(planes: list[torch.Tensor], j: int, k: int):
    nb, width = planes[0].shape
    groups = width // (2 * j)
    v = [p.reshape(nb, groups, 2, j) for p in planes]
    al, bl = widen(v[0][:, :, 0]), widen(v[0][:, :, 1])
    ah, bh = widen(v[1][:, :, 0]), widen(v[1][:, :, 1])
    gt = (ah > bh) | ((ah == bh) & (al > bl))
    start = torch.arange(groups, device=planes[0].device) * (2 * j)
    up = ((start & k) == 0)[None, :, None]
    swap = gt == up
    return [torch.stack((torch.where(swap, x[:, :, 1], x[:, :, 0]),
                         torch.where(swap, x[:, :, 0], x[:, :, 1])),
                        dim=2).reshape(nb, width) for x in v]


def sort_chunks_plain(lo: torch.Tensor, hi: torch.Tensor,
                      *payloads: torch.Tensor, rows: int = 64):
    """Plain twin of B5: the bitonic network written in torch, over chunks
    of lo.shape[1] = rows * 128 keys (the wrapper checks the arguments)."""
    planes = [lo, hi, *payloads]
    width = lo.shape[1]
    k = 2
    while k <= width:
        j = k // 2
        while j >= 1:
            planes = _stage_plain(planes, j, k)
            j //= 2
        k *= 2
    return tuple(planes)


def shared_tile(width: int, n_planes: int, device: torch.device) -> int:
    """Elements per tile that the CUDA kernel sorts in registers and shared
    memory for chunks of `width` with `n_planes` planes on `device`; a
    chunk wider than this runs its long strides in global memory."""
    tile = library().tq_sort_chunks_tile(width, n_planes, device.index)
    if tile < 1:
        raise RuntimeError(f"cannot read the tile size for {device}")
    return tile


def sort_chunks(lo: torch.Tensor, hi: torch.Tensor, *payloads: torch.Tensor,
                rows: int = 64):
    """Sort each chunk of rows * 128 keys by the u64 key (hi, lo) (B5).

    lo, hi and each payload are (nb, rows * 128) int32 planes of u32 bit
    patterns; the chunk width must be a power of two. At most 8 payloads.
    Returns the tuple (lo, hi, *payloads) of new, chunk-wise sorted planes.
    Chunks wider than the kernel's tile are taken: the strides beyond the
    tile run as global-memory launches, and LAUNCHES["sort_chunks"] counts
    every launch.
    """
    planes = [lo, hi, *payloads]
    dev = _check_args(planes, rows)
    if dev.type == "cpu":
        return sort_chunks_plain(lo, hi, *payloads, rows=rows)
    nb, width = lo.shape
    # the kernel loads 16 bytes a thread: a view that starts off that
    # alignment is copied
    planes = [p if p.data_ptr() % 16 == 0 else p.clone() for p in planes]
    outs = [torch.empty_like(p) for p in planes]
    ptrs = ctypes.c_void_p * _MAX_PLANES
    lib = library()
    # tile launches beyond the first, one per merge size beyond the tile
    m = (width // shared_tile(width, len(planes), dev)).bit_length() - 1
    # a wide chunk's payloads follow an index plane that is sorted with the
    # keys; the kernel takes it as scratch
    index = torch.empty_like(lo) if m and payloads else None
    check(lib, lib.tq_sort_chunks(
        ptrs(*[p.data_ptr() for p in planes]),
        ptrs(*[o.data_ptr() for o in outs]), len(planes), nb, width,
        None if index is None else index.data_ptr(), dev.index,
        stream_of(lo)), "sort_chunks")
    if nb:
        # one tile launch; then per merge size beyond the tile its
        # global-memory stages and one more tile launch
        LAUNCHES["sort_chunks"] += 1 + m * (m + 3) // 2
    return tuple(outs)
