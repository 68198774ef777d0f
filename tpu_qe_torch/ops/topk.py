"""Top-k selection (ORDER BY key LIMIT k): the port of tpu_qe/ops/topk.py.

A full stable sort by the u64 key and the first k rows, as in the JAX
package (its measured choice on the TPU). The sort runs through
``argsort_planes``; the JAX package's row-index tie-break key is dropped,
since the sort is stable, and only the k selected rows of the other
columns are gathered.
"""

from __future__ import annotations

from typing import NamedTuple

from tpu_qe_torch.bits import U64
from tpu_qe_torch.sort.planes import argsort_planes
from tpu_qe_torch.table import Table


class TopKResult(NamedTuple):
    table: Table   # k rows, best first (includes the key column)


def top_k(table: Table, k: int, key: str = "key", largest: bool = False,
          backend: str = "radix") -> TopKResult:
    """k rows with the smallest (default) or largest u64 `key`, best first;
    ties keep the original row order (a stable full sort + head)."""
    kcol = table[key]
    if not isinstance(kcol, U64):
        raise TypeError("top_k key must be u64")
    n = table.num_rows
    if not (0 < k <= n):
        raise ValueError(f"k must be in (0, {n}]: {k}")
    whi, wlo = (~kcol.hi, ~kcol.lo) if largest else (kcol.hi, kcol.lo)
    (shi, slo), perm = argsort_planes([whi, wlo], backend=backend)
    shi, slo = shi[:k], slo[:k]
    if largest:
        shi, slo = ~shi, ~slo
    body = table.drop(key).take(perm[:k])
    return TopKResult(body.with_column(key, U64(slo, shi)))
