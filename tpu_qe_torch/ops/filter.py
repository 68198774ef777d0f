"""Filter / stream compaction over columnar tables: the port of
tpu_qe/ops/filter.py.

A filter returns the same-length table with the selected rows moved
stably to the front and the count: the selection-vector form of the JAX
package. The JAX package compacts with a sort whose key packs the
keep/drop bit into bit 31 of the unique row position; that order is a
stable two-way partition, which the port computes directly from one
cumulative sum and one scatter (``stable_partition``). The rows come out
in the same order.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpu_qe_torch.table import Table


def stable_partition(keep: torch.Tensor) -> torch.Tensor:
    """int64 gather order that puts rows with keep=True first and the
    others after them, each side in row order."""
    n = keep.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=keep.device)
    kept_upto = torch.cumsum(keep.to(torch.int64), 0)   # inclusive
    num_kept = kept_upto[-1:] if n else kept_upto
    dest = torch.where(keep, kept_upto - 1, num_kept + pos - kept_upto)
    order = torch.empty_like(pos)
    order[dest] = pos
    return order


def compact(table: Table, mask: torch.Tensor):
    """Stably move rows where mask is True to the front.

    Returns (table, count): rows [0, count) are the selected rows in their
    original order; the rows beyond are the unselected rows, also stable.
    count is a 0-d int64 tensor.
    """
    return table.take(stable_partition(mask)), mask.sum(dtype=torch.int64)


def filter_table(table: Table, predicate: Callable[[Table], torch.Tensor]):
    """Filter by a row predicate: predicate(table) -> bool mask."""
    return compact(table, predicate(table))
