"""The flagship pipeline: scene -> extended morton codes -> sorted index."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_qe_torch import morton, native
from tpu_qe_torch.bits import U64
from tpu_qe_torch.config import SceneConfig, SortConfig, resolve_device
from tpu_qe_torch.sort import sort_u64


class MortonIndex(NamedTuple):
    """Sorted (morton code, triangle index) pairs."""

    code: U64             # sorted morton codes
    order: torch.Tensor   # int32 triangle index per sorted position


def sorted_morton_index(verts: torch.Tensor, tris: torch.Tensor,
                        params: morton.MortonParams,
                        sort: SortConfig | None = None) -> MortonIndex:
    """Encode triangles and stably sort (code, index) on their device."""
    sort = sort or SortConfig()
    code = morton.encode(verts, tris, params)
    idx = torch.arange(tris.shape[0], dtype=torch.int32, device=tris.device)
    skey, (sidx,) = sort_u64(code, idx, backend=sort.backend,
                             key_bits=sort.key_bits,
                             bits_per_pass=sort.bits_per_pass,
                             block=sort.block)
    return MortonIndex(skey, sidx)


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
