"""The flagship pipeline: scene -> extended morton codes -> sorted index."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_qe_torch import morton, native
from tpu_qe_torch.bits import U64, narrow
from tpu_qe_torch.config import SceneConfig, SortConfig, resolve_device
from tpu_qe_torch.sort import sort_u64
from tpu_qe_torch.utils.profiling import span


class MortonIndex(NamedTuple):
    """Sorted (morton code, triangle index) pairs."""

    code: U64             # sorted morton codes
    order: torch.Tensor   # int32 triangle index per sorted position


def sorted_morton_index(verts: torch.Tensor, tris: torch.Tensor,
                        params: morton.MortonParams,
                        sort: SortConfig | None = None) -> MortonIndex:
    """Encode triangles and stably sort (code, index) on their device.
    Traced as morton.frame, the encode inside it as morton.encode."""
    sort = sort or SortConfig()
    with span("morton.frame"):
        with span("morton.encode"):
            code = morton.encode(verts, tris, params)
        idx = torch.arange(tris.shape[0], dtype=torch.int32,
                           device=tris.device)
        skey, (sidx,) = sort_u64(code, idx, backend=sort.backend,
                                 key_bits=sort.key_bits,
                                 bits_per_pass=sort.bits_per_pass,
                                 block=sort.block)
        return MortonIndex(skey, sidx)


def sorted_morton_index_distributed(x, y, z, params: morton.MortonParams,
                                    mesh, size=None,
                                    capacity_factor="auto",
                                    overlap: int = 1,
                                    backend: str = "radix"):
    """Mesh-sharded flagship: encode columnar points + distributed sort.

    Morton encoding is elementwise, so each shard encodes its own rows on
    the mesh's device; the sorted index comes from the distributed sample
    sort (exchange/dsort.py), with demand-sized capacity ("auto") and
    k-way overlap.

    Args:
      x, y, z (+ optional size): (n,) float32 numpy arrays or tensors, n
        divisible by the mesh size.
    Returns (DistSortResult, overflow), as exchange.dsort.distributed_sort:
    shard s's run holds the s-th quantile of the global code order with
    the original row index as payload.
    """
    from tpu_qe_torch.exchange.dsort import auto_capacity, distributed_sort

    def shard(c):
        return mesh.shard(torch.as_tensor(np.asarray(c, np.float32)
                                          if not torch.is_tensor(c) else c))

    xs, ys, zs = shard(x), shard(y), shard(z)
    shards, n_local = xs.shape
    code = morton.encode_points(
        xs.reshape(-1), ys.reshape(-1), zs.reshape(-1), params,
        size=None if size is None else shard(size).reshape(-1))
    code = U64(code.lo.reshape(shards, n_local),
               code.hi.reshape(shards, n_local))
    idx = narrow(mesh.ranks()[:, None] * n_local
                 + torch.arange(n_local, device=xs.device))
    kw = {}
    if capacity_factor == "auto":
        if mesh.n_dev > 1:
            kw["capacity"] = auto_capacity(code, mesh, backend=backend)
    else:
        kw["capacity_factor"] = capacity_factor
    return distributed_sort(code, idx, mesh=mesh, overlap=overlap,
                            backend=backend, **kw)


def scene_tensors(scene: SceneConfig, device: str | torch.device):
    """The seeded scene on `device`: (verts, tris int32, MortonParams)."""
    verts, tris, smin, smax = native.scene_generate(
        scene.num_vertices, scene.num_triangles, scene.seed)
    params = morton.MortonParams.for_scene(smin, smax, device)
    return (torch.from_numpy(verts).to(device),
            torch.from_numpy(tris.astype(np.int32)).to(device), params)


def build_scene_index(scene: SceneConfig | None = None,
                      sort: SortConfig | None = None,
                      device: str | torch.device = "cuda") -> MortonIndex:
    """Generate the seeded reference scene and build its sorted index."""
    dev = resolve_device(device)
    verts, tris, params = scene_tensors(scene or SceneConfig(), dev)
    return sorted_morton_index(verts, tris, params, sort)
