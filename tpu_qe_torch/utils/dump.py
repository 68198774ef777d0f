"""Golden-file dumps, byte-compatible with the reference's readback dump:
``morton_codes.txt`` holds one decimal u64 code per line, ``indices.txt``
one ``(x, y, z)`` triangle per line."""

from __future__ import annotations

import os

import numpy as np


def dump_morton_codes(codes: np.ndarray, path: str = "morton_codes.txt") -> str:
    codes = np.asarray(codes, dtype=np.uint64)
    with open(path, "w") as f:
        for v in codes:
            f.write(f"{int(v)}\n")
    return os.path.abspath(path)


def dump_indices(tris: np.ndarray, path: str = "indices.txt") -> str:
    tris = np.asarray(tris).reshape(-1, 3)
    with open(path, "w") as f:
        for x, y, z in tris:
            f.write(f"({int(x)}, {int(y)}, {int(z)})\n")
    return os.path.abspath(path)
