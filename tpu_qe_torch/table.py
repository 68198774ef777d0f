"""Columnar tables on one device: the port of tpu_qe/table.py.

Column types, as tensors on one device:
- u32: ``torch.uint32``. torch's uint32 tensors reject shifts, comparisons
  and most arithmetic, so the dtype only tells a u32 column apart from an
  i32 one; every operator views it as its int32 bit-pattern plane
  (``plane``) and views results back (``from_plane``).
- i32: ``torch.int32``; f32: ``torch.float32``;
- u64: ``U64(lo, hi)``, two int32 planes of u32 bit patterns.

`Table.from_numpy` takes the same numpy dict as the JAX `Table.from_numpy`
(uint64, uint32, int32, float32 arrays), which is how data crosses between
the two packages. Operators that sort data take ``backend`` ("radix", the
CUDA radix kernels, or "torch", the ``torch.sort`` baseline).
"""

from __future__ import annotations

import os
from typing import Iterator, Mapping

import numpy as np
import torch

from tpu_qe_torch.bits import U64, as_i32
from tpu_qe_torch.config import resolve_device

Column = torch.Tensor | U64
DTYPES = (torch.uint32, torch.int32, torch.float32)


def plane(c: torch.Tensor) -> torch.Tensor:
    """The int32 bit-pattern plane of a u32 / i32 / f32 column."""
    if c.dtype not in DTYPES:
        raise TypeError(f"unsupported column dtype {c.dtype}")
    return c if c.dtype == torch.int32 else c.view(torch.int32)


def from_plane(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of `plane`: the column of `dtype` with the bits of `p`."""
    return p if dtype == torch.int32 else p.view(dtype)


def take_column(c: Column, idx: torch.Tensor) -> Column:
    """Row gather of one column."""
    if isinstance(c, U64):
        return U64(c.lo[idx], c.hi[idx])
    return from_plane(plane(c)[idx], c.dtype)


def column_to_numpy(c: Column) -> np.ndarray:
    if isinstance(c, U64):
        return c.to_numpy()
    a = plane(c).cpu().numpy()
    return {torch.uint32: a.view(np.uint32), torch.int32: a,
            torch.float32: a.view(np.float32)}[c.dtype]


def column_from_numpy(v: np.ndarray, device) -> Column:
    v = np.asarray(v)
    if v.dtype == np.uint64:
        return U64.from_numpy(v, device)
    dtype = {np.dtype(np.uint32): torch.uint32,
             np.dtype(np.int32): torch.int32,
             np.dtype(np.float32): torch.float32}.get(v.dtype)
    if dtype is None:
        raise TypeError(f"unsupported dtype {v.dtype}")
    p = torch.from_numpy(np.ascontiguousarray(v).view(np.int32)).to(device)
    return from_plane(p, dtype)


def _check_format(format: str) -> None:
    """The persistence formats of the JAX package's Table: "npz" is
    implemented; "orbax" (a checkpoint directory) needs a package that the
    port does not carry."""
    if format == "orbax":
        raise ImportError("format 'orbax' needs the orbax-checkpoint package "
                          "(orbax.checkpoint), which tpu_qe_torch does not "
                          "use: save and load with format='npz'")
    if format != "npz":
        raise ValueError(f"unknown format {format!r}")


class Table:
    """Immutable named-column table."""

    def __init__(self, columns: Mapping[str, Column]):
        self._cols = dict(columns)
        lens = {self._len(c) for c in self._cols.values()}
        if len(lens) > 1:
            raise ValueError("ragged columns: "
                             f"{ {k: self._len(v) for k, v in self._cols.items()} }")

    @staticmethod
    def _len(c: Column) -> int:
        return c.lo.shape[0] if isinstance(c, U64) else c.shape[0]

    # -- basic access -------------------------------------------------------
    @property
    def num_rows(self) -> int:
        return self._len(next(iter(self._cols.values()))) if self._cols else 0

    @property
    def column_names(self) -> list[str]:
        return sorted(self._cols)

    def __getitem__(self, name: str) -> Column:
        return self._cols[name]

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._cols))

    def select(self, *names: str) -> "Table":
        return Table({n: self._cols[n] for n in names})

    def with_column(self, name: str, col: Column) -> "Table":
        cols = dict(self._cols)
        cols[name] = col
        return Table(cols)

    def drop(self, *names: str) -> "Table":
        return Table({k: v for k, v in self._cols.items() if k not in names})

    # -- conversion ---------------------------------------------------------
    @staticmethod
    def from_numpy(columns: Mapping[str, np.ndarray],
                   device: str | torch.device = "cuda") -> "Table":
        """The columns on `device`, the card unless the caller names
        another; a CUDA device without CUDA raises."""
        dev = resolve_device(device)
        return Table({k: column_from_numpy(v, dev)
                      for k, v in columns.items()})

    def to_numpy(self) -> dict[str, np.ndarray]:
        return {k: column_to_numpy(v) for k, v in self._cols.items()}

    def take(self, idx: torch.Tensor) -> "Table":
        """Row gather."""
        return Table({k: take_column(v, idx) for k, v in self._cols.items()})

    def head(self, n: int) -> "Table":
        def h(c):
            return U64(c.lo[:n], c.hi[:n]) if isinstance(c, U64) else c[:n]
        return Table({k: h(v) for k, v in self._cols.items()})

    # -- query operators ----------------------------------------------------
    def sort_by(self, key: str, backend: str = "radix") -> "Table":
        """Rows reordered by ascending u64 key column (stable)."""
        from tpu_qe_torch.sort.planes import argsort_planes
        k = self._u64(key, "sort")
        (shi, slo), perm = argsort_planes([k.hi, k.lo], backend=backend)
        cols = {n: take_column(c, perm) for n, c in self._cols.items()
                if n != key}
        cols[key] = U64(slo, shi)
        return Table(cols)

    def order_by(self, *by, backend: str = "radix") -> "Table":
        """Multi-column SQL ORDER BY (stable): items are "name" or
        ("name", "asc"|"desc"); keys may be U64/uint32/int32/float32."""
        from tpu_qe_torch.ops.orderby import sort_by_multi
        if len(by) == 1 and not isinstance(by[0], (str, tuple)):
            by = tuple(by[0])  # accept a single list/iterable too
        return sort_by_multi(self, by, backend=backend)

    def filter(self, predicate):
        """Stable compaction of rows where predicate(self) is True.
        Returns (table, count): rows [0, count) are the selected rows."""
        from tpu_qe_torch.ops.filter import filter_table
        return filter_table(self, predicate)

    def _u64(self, name: str, what: str) -> U64:
        k = self._cols[name]
        if not isinstance(k, U64):
            raise TypeError(f"{what} key {name!r} must be u64")
        return k

    def distinct(self, key: str = "key", backend: str = "radix"):
        """SELECT DISTINCT key: (unique U64 keys ascending, padded; exact
        count)."""
        from tpu_qe_torch.ops.aggregate import group_aggregate
        res = group_aggregate(self._u64(key, "distinct"), aggs=("count",),
                              backend=backend)
        return res.key, res.num_groups

    def group_by(self, key: str, value: str | None = None,
                 aggs=("count",), backend: str = "radix"):
        """Sort-based GROUP BY over a u64 key column."""
        from tpu_qe_torch.ops.aggregate import group_aggregate
        v = None if value is None else self._cols[value]
        return group_aggregate(self._u64(key, "group"), v, aggs=tuple(aggs),
                               backend=backend)

    def group_by_multi(self, key: str, aggs: dict, valid=None,
                       max_groups: int | None = None,
                       backend: str = "radix"):
        """Multi-column GROUP BY: aggs = {column_name: (agg, ...)}."""
        from tpu_qe_torch.ops.aggregate import group_aggregate_multi
        values = {nm: self._cols[nm] for nm in aggs}
        return group_aggregate_multi(self._u64(key, "group"), values, aggs,
                                     valid=valid, max_groups=max_groups,
                                     backend=backend)

    def join(self, right: "Table", key: str = "key",
             backend: str = "radix"):
        """FK equi-join against `right` on a shared u64 key column."""
        from tpu_qe_torch.ops.join import join_fk_scan
        lkey, rkey = self._u64(key, "join"), right._u64(key, "join")
        return join_fk_scan(self.drop(key), right.drop(key), lkey, rkey,
                            backend=backend)

    def join_inner(self, right: "Table", key: str = "key",
                   out_budget: int | None = None, backend: str = "radix"):
        """One-to-many inner equi-join into a padded static budget."""
        from tpu_qe_torch.ops.join import join_inner
        return join_inner(self, right, key=key, out_budget=out_budget,
                          backend=backend)

    def join_outer(self, right: "Table", key: str = "key",
                   how: str = "left", out_budget: int | None = None,
                   backend: str = "radix"):
        """One-to-many LEFT/FULL OUTER equi-join (ops.join.join_outer)."""
        from tpu_qe_torch.ops.join import join_outer
        return join_outer(self, right, key=key, how=how,
                          out_budget=out_budget, backend=backend)

    def join_semi(self, right: "Table", key: str = "key",
                  backend: str = "radix"):
        """Semi join: my rows whose key appears in `right`, stably
        compacted to the front. Returns (table, count)."""
        from tpu_qe_torch.ops.filter import compact
        _, matched = self.join(right.select(key), key=key, backend=backend)
        return compact(self, matched)

    def join_anti(self, right: "Table", key: str = "key",
                  backend: str = "radix"):
        """Anti join: my rows whose key does NOT appear in `right`, stably
        compacted to the front. Returns (table, count)."""
        from tpu_qe_torch.ops.filter import compact
        _, matched = self.join(right.select(key), key=key, backend=backend)
        return compact(self, ~matched)

    def set_op(self, other: "Table", op: str, key: str = "key",
               backend: str = "radix"):
        """SQL UNION / INTERSECT / EXCEPT (distinct) over a shared u64 key
        column: (keys, count_self, count_other, num), ops.setops.set_op."""
        from tpu_qe_torch.ops.setops import set_op
        return set_op(self._u64(key, "set-op"), other._u64(key, "set-op"),
                      op, backend=backend)

    def top_k(self, k: int, key: str = "key", largest: bool = False,
              backend: str = "radix"):
        """k rows with the smallest/largest u64 key, best first (stable)."""
        from tpu_qe_torch.ops.topk import top_k
        return top_k(self, k, key=key, largest=largest, backend=backend)

    # -- persistence (the JAX package's npz layout) ------------------------
    def save(self, path: str, format: str = "npz") -> str:
        """Write a single-file .npz: u64 columns as `name@lo` / `name@hi`
        u32 planes, others as their numpy arrays. `format` is the JAX
        package's argument: "npz" is the layout above."""
        _check_format(format)
        out = {}
        for name, c in self._cols.items():
            if name.endswith("@lo") or name.endswith("@hi"):
                raise ValueError(f"column name {name!r} collides with the "
                                 "u64 plane encoding ('@lo'/'@hi')")
            if isinstance(c, U64):
                out[f"{name}@lo"] = c.lo.cpu().numpy().view(np.uint32)
                out[f"{name}@hi"] = c.hi.cpu().numpy().view(np.uint32)
            else:
                out[name] = column_to_numpy(c)
        np.savez(path, **out)
        return os.path.abspath(path if path.endswith(".npz")
                               else path + ".npz")

    @staticmethod
    def load(path: str, format: str = "npz", *,
             device: str | torch.device = "cuda") -> "Table":
        """Load a Table written by save() (or by the JAX package's npz
        checkpoint) onto `device`, the card unless the caller names another;
        a CUDA device without CUDA raises."""
        _check_format(format)
        device = resolve_device(device)
        cols = {}
        with np.load(path) as z:
            for k in z.files:
                if k.endswith("@lo"):
                    lo, hi = z[k], z[k[:-3] + "@hi"]
                    cols[k[:-3]] = U64(
                        torch.from_numpy(as_i32(lo)).to(device),
                        torch.from_numpy(as_i32(hi)).to(device))
                elif not k.endswith("@hi"):
                    cols[k] = column_from_numpy(z[k], device)
        return Table(cols)

    def __repr__(self) -> str:
        parts = ", ".join(
            f"{k}: {'u64' if isinstance(v, U64) else v.dtype}"
            for k, v in sorted(self._cols.items()))
        return f"Table[{self.num_rows} rows]({parts})"
