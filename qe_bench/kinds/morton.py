"""A triangle scene made on the device from a seed, served one frame at a
time through the program's sorted morton index.

The scene: ``num_vertices`` vertices uniform in the box [0, 1 - max
offset)^3 and ``num_triangles`` triangles of three vertex indices uniform
over all vertices, drawn by torch on the device from one seeded
``torch.Generator``. A frame moves every vertex by the request's offset
(each component in [0, max offset), so the scene stays inside the box
[0, 1]^3 that the morton parameters are built for once) and rebuilds the
sorted (morton code, triangle index) pairs: the first stage of an LBVH
rebuild.
"""

from __future__ import annotations

import torch

BOX_MIN = (0.0, 0.0, 0.0)
BOX_MAX = (1.0, 1.0, 1.0)


def make_data(cfg: dict, seed: int, device) -> dict:
    """{"verts": (V, 3) float32, "tris": (T, 3) int32} drawn from `seed`,
    and the box they are quantized in."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    v, t = cfg["num_vertices"], cfg["num_triangles"]
    verts = torch.rand((v, 3), generator=g, device=device) \
        * (1.0 - cfg["max_offset"])
    tris = torch.randint(0, v, (t, 3), generator=g, device=device,
                         dtype=torch.int32)
    return {"verts": verts, "tris": tris, "box": (BOX_MIN, BOX_MAX)}


def fact_rows(data: dict) -> int:
    """Triangles every frame encodes and sorts."""
    return data["tris"].shape[0]


def setup(data: dict, device):
    """The program's morton parameters of the box, built once."""
    from tpu_qe_torch.morton import MortonParams
    return {"data": data,
            "params": MortonParams.for_scene(*data["box"], device)}


def serve(state: dict, mix: dict, params: dict):
    """One frame: the displaced vertices' sorted morton index."""
    from tpu_qe_torch.pipeline import sorted_morton_index
    data = state["data"]
    offset = torch.tensor(params["offset"], dtype=torch.float32,
                          device=data["verts"].device)
    return sorted_morton_index(data["verts"] + offset, data["tris"],
                               state["params"])


def answer_of(result) -> dict:
    """The frame's result as the reference gives it: the sorted codes'
    int32 planes and the triangle order."""
    return {"code_lo": result.code.lo, "code_hi": result.code.hi,
            "order": result.order}
