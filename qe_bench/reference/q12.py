"""Plain reference of TPC-H Q12 (shipping modes and order priority) over
the generated ORDERS and LINEITEM, in torch on the data's device.

LINEITEM's predicates first, then each surviving line's order found by a
binary search of its key among ORDERS' sorted keys, then the two counts
per ship mode. With ``lower`` the keys are searched as float32, which
holds integers exactly only up to 2^24: the control, a join that matches
on rounded keys."""

from __future__ import annotations

import numpy as np
import torch


def answer(data: dict, params: dict, lower: bool = False) -> dict:
    li, o = data["lineitem"], data["orders"]
    mode, rd = li["l_shipmode"], li["l_receiptdate"]
    m1, m2 = params["modes"]
    m = (((mode == m1) | (mode == m2))
         & (li["l_commitdate"] < rd) & (li["l_shipdate"] < li["l_commitdate"])
         & (rd >= params["d0"]) & (rd < params["d1"]))
    keys, okeys = li["l_orderkey"][m], o["o_orderkey"]
    if lower:
        idx = torch.searchsorted(okeys.float(), keys.float())
        idx = idx.clamp(max=okeys.shape[0] - 1)
    else:
        idx = torch.searchsorted(okeys, keys)
        if not torch.equal(okeys[idx], keys):
            raise ValueError("a line's order key is not among the orders")
    high = o["o_orderpriority"][idx] <= 1           # 1-URGENT, 2-HIGH
    mode = mode[m].long()
    n_high = torch.bincount(mode[high], minlength=7).cpu().numpy()
    n_all = torch.bincount(mode, minlength=7).cpu().numpy()
    present = np.flatnonzero(n_all)
    return {"l_shipmode": present.astype(np.uint32),
            "high_line_count": n_high[present].astype(np.int64),
            "low_line_count": (n_all - n_high)[present].astype(np.int64)}
