"""The one generator of requests: reads a traffic mix's data file.

A mix (``traffic/<name>.json``) holds:

- ``grid``: parameters that take each of a list of values. A value is a
  number, a list, or an object whose keys are merged into the request's
  parameters; ``{"range": [a, b]}`` stands for the integers a..b. Every
  combination of the grid's values is one request's parameters. The seed
  orders the combinations; once all have been sent they are sent again in
  a new order, so every seed serves the same set of requests, in another
  order.
- ``draw``: parameters drawn anew for every request,
  ``{"uniform": [lo, hi], "size": k}`` (k floats uniform on [lo, hi)).
- anything else the configuration's kind reads (a query's text).
"""

from __future__ import annotations

import itertools
from typing import Iterator

import numpy as np


def _values(spec) -> list:
    if isinstance(spec, dict) and set(spec) == {"range"}:
        lo, hi = spec["range"]
        return list(range(lo, hi + 1))
    if not isinstance(spec, list) or not spec:
        raise ValueError(f"a grid entry is a non-empty list or a range, "
                         f"not {spec!r}")
    return spec


def grid_size(mix: dict) -> int:
    """How many distinct parameter sets the mix's grid holds."""
    return int(np.prod([len(_values(v))
                        for v in mix.get("grid", {}).values()]))


def requests(mix: dict, seed: int) -> Iterator[dict]:
    """The endless seeded stream of request parameters of `mix`."""
    rng = np.random.default_rng(seed)
    keys = sorted(mix.get("grid", {}))
    combos = list(itertools.product(*(_values(mix["grid"][k])
                                      for k in keys)))
    draws = sorted(mix.get("draw", {}).items())
    while True:
        for i in rng.permutation(len(combos)):
            params = {}
            for k, v in zip(keys, combos[i]):
                if isinstance(v, dict):
                    params.update(v)
                else:
                    params[k] = v
            for k, spec in draws:
                lo, hi = spec["uniform"]
                params[k] = rng.uniform(lo, hi, spec.get("size", 1)).tolist()
            yield params
