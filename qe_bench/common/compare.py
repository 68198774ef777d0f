"""The comparison that decides `correct`: exact, value by value.

An answer is {column: array}, numpy arrays or tensors. Integers compare
as integers and floats as floats, bit for bit: the configurations state
exact answers (integer sums exact, averages the exact sum over the exact
count, morton codes and orders exact), so the limit on every count below
is 0.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(a) -> np.ndarray:
    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    if a.dtype.kind in "iub":
        return a.astype(np.int64)       # every value here is below 2^63
    return a.astype(np.float64)


def mismatches(got: dict, want: dict) -> int:
    """How many values of `want` that `got` does not hold: a missing or
    extra column counts all its rows, a row count that differs counts the
    rows that differ."""
    bad = 0
    for name in set(got) | set(want):
        if name not in got or name not in want:
            bad += len((got if name in got else want)[name])
            continue
        g, w = got[name], want[name]
        if torch.is_tensor(g) and torch.is_tensor(w) and g.shape == w.shape:
            bad += int((g.to(w.device) != w).sum())
            continue
        g, w = _host(g), _host(w)
        n = min(len(g), len(w))
        bad += int((g[:n] != w[:n]).sum()) + abs(len(g) - len(w))
    if list(got) != list(want) and not bad:
        bad = 1                            # the columns come out of order
    return bad
