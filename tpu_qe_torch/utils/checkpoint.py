"""Persistence: tables as single-file npz, and the checkpoint state of an
out-of-core sort run. The port of tpu_qe/utils/checkpoint.py, with the
same file layouts, so a file written by either package loads in the
other.

A table's npz holds u64 columns as `name@lo` / `name@hi` u32 planes and
the other columns as their numpy arrays. The JAX package's orbax
directory checkpoints (save_table / load_table) need a package that the
port does not carry: they raise ImportError, as Table.save(format="orbax")
does.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpu_qe_torch.bits import U64, as_i32
from tpu_qe_torch.config import resolve_device
from tpu_qe_torch.table import Table, _check_format, column_from_numpy, \
    column_to_numpy


def save_table(table: Table, path: str) -> str:
    """The JAX package's orbax directory checkpoint: raises ImportError."""
    _check_format("orbax")


def load_table(path: str, *, device: str | torch.device = "cuda") -> Table:
    """The JAX package's orbax directory restore: raises ImportError."""
    _check_format("orbax")


def save_table_npz(table: Table, path: str) -> str:
    """Write `table` as a single-file .npz (numpy appends the suffix when
    `path` lacks it); returns os.path.abspath(path)."""
    out = {}
    for name in table:
        if name.endswith("@lo") or name.endswith("@hi"):
            raise ValueError(f"column name {name!r} collides with the u64 "
                             "plane encoding (reserved suffixes '@lo'/'@hi')")
        c = table[name]
        if isinstance(c, U64):
            out[f"{name}@lo"] = c.lo.cpu().numpy().view(np.uint32)
            out[f"{name}@hi"] = c.hi.cpu().numpy().view(np.uint32)
        else:
            out[name] = column_to_numpy(c)
    np.savez(path, **out)
    return os.path.abspath(path)


def load_table_npz(path: str, *,
                   device: str | torch.device = "cuda") -> Table:
    """A Table from an npz written by save_table_npz (or by the JAX
    package), on `device`: the card unless the caller names another."""
    device = resolve_device(device)
    cols = {}
    with np.load(path) as z:
        for k in z.files:
            if k.endswith("@lo"):
                cols[k[:-3]] = U64(
                    torch.from_numpy(as_i32(z[k])).to(device),
                    torch.from_numpy(as_i32(z[k[:-3] + "@hi"])).to(device))
            elif not k.endswith("@hi"):
                cols[k] = column_from_numpy(z[k], device)
    return Table(cols)


class RunState:
    """Checkpoint state of an out-of-core sort run (sort/bigsort.py).

    The resident runs are not persisted: run formation is a deterministic
    function of (n, run_size, seed) and is regenerated. What a restart
    cannot re-derive is the splitter plan (completed buckets mean nothing
    against other boundaries) and which buckets already merged, with their
    verification scalars. Both are small and are written atomically (tmp
    file + rename) after the plan and after every bucket, so a run killed
    at any point resumes with identical output.
    """

    N_SCALARS = 9  # s_ok, h_ok, cnt, psum, psq, flo, fhi, llo, lhi

    def __init__(self, path: str, meta: np.ndarray, bounds: np.ndarray,
                 done: np.ndarray, scalars: np.ndarray):
        self.path = path
        self.meta = meta
        self.bounds = bounds
        self.done = done
        self.scalars = scalars

    @classmethod
    def fresh(cls, directory: str, meta: np.ndarray, bounds: np.ndarray,
              n_buckets: int, n_scalars: int | None = None) -> "RunState":
        st = cls(cls._path(directory), meta, bounds,
                 np.zeros(n_buckets, np.int64),
                 np.zeros((n_buckets, n_scalars or cls.N_SCALARS), np.int64))
        st.save()
        return st

    @staticmethod
    def _path(directory: str) -> str:
        return os.path.join(directory, "bigsort_state.npz")

    @classmethod
    def load(cls, directory: str, meta: np.ndarray) -> "RunState | None":
        """Load a matching checkpoint; None if absent or for another run
        configuration (a mismatched plan must never be reused)."""
        p = cls._path(directory)
        if not os.path.exists(p):
            return None
        with np.load(p) as z:
            if not np.array_equal(z["meta"], meta):
                return None
            return cls(p, meta, z["bounds"], z["done"], z["scalars"])

    def save(self) -> None:
        tmp = self.path + ".tmp.npz"  # np.savez appends .npz otherwise
        np.savez(tmp, meta=self.meta, bounds=self.bounds, done=self.done,
                 scalars=self.scalars)
        os.replace(tmp, self.path)

    def record(self, b: int, vals) -> None:
        self.scalars[b] = [int(v) for v in vals]
        self.done[b] = 1
        self.save()
