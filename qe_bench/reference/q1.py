"""Plain reference of TPC-H Q1 (pricing summary report) over the
generated LINEITEM, in torch on the data's device.

The sums are exact in int64. ``sum_charge_hi`` and ``sum_charge_lo`` are
the spec's charge split at 1024 cents of the extended price, so that
every term fits the program's 32-bit row expressions (the configuration's
``assumed``); hi * 1024 + lo is the spec's exact sum. The averages are
float64 of the exact sum over the exact count. With ``lower`` every value
and sum is float32 instead: the control.
"""

from __future__ import annotations

import numpy as np
import torch

DATE_MAX = 10561          # 1998-12-01 as days since 1970-01-01


def answer(data: dict, params: dict, lower: bool = False) -> dict:
    li = data["lineitem"]
    m = li["l_shipdate"] <= DATE_MAX - params["delta"]
    dtype = torch.float32 if lower else torch.int64

    def col(name):
        return li[name][m].to(dtype)

    q, p, d, t = (col(c) for c in ("l_quantity", "l_extendedprice",
                                   "l_discount", "l_tax"))
    if lower:
        hi, lo = torch.floor(p / 1024), torch.remainder(p, 1024)
    else:
        hi, lo = p // 1024, p % 1024
    keep = (100 - d) * (100 + t)
    values = {"sum_qty": q, "sum_base_price": p,
              "sum_disc_price": p * (100 - d), "sum_charge_hi": hi * keep,
              "sum_charge_lo": lo * keep, "d": d}
    group = li["l_returnflag"][m].long() * 2 + li["l_linestatus"][m].long()
    count = torch.bincount(group, minlength=6)
    sums = {}
    for name, v in values.items():
        s = torch.zeros(6, dtype=dtype, device=v.device)
        sums[name] = s.index_add_(0, group, v).cpu().numpy()
    count = count.cpu().numpy()
    present = np.flatnonzero(count)          # in (flag, status) order
    cnt = count[present]
    out = {"l_returnflag": (present // 2).astype(np.uint32),
           "l_linestatus": (present % 2).astype(np.uint32)}
    for name in ("sum_qty", "sum_base_price", "sum_disc_price",
                 "sum_charge_hi", "sum_charge_lo"):
        out[name] = sums[name][present]
    for name, src in (("avg_qty", "sum_qty"), ("avg_price", "sum_base_price"),
                      ("avg_disc", "d")):
        out[name] = sums[src][present].astype(np.float64) / cnt
    out["count_order"] = cnt.astype(np.int64)
    return out
