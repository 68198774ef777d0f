"""Plain reference of TPC-H Q18 (large volume customer) over the generated
CUSTOMER, ORDERS and LINEITEM, in torch on the data's device.

Each line's order is found by a binary search of its key among ORDERS'
sorted keys; the per-order quantity sums are a bincount over that order
index. The orders whose sum passes the threshold, then their lines, give
the groups: one per order (its customer's name and key, its key, date and
total price, the sum of its lines' quantities). The groups are ordered by
total price descending, then order date, ties by the group columns in
order (the answer's own order of ties), and the first 100 kept. The
columns take the names of the query's text (its unaliased SUM is
``sum_5``). With ``lower`` the total prices and the sums are float32,
which holds integers exactly only up to 2^24: the control, whose prices
(up to ~5e8 cents) come out rounded, and so may their order."""

from __future__ import annotations

import torch

LIMIT = 100


def answer(data: dict, params: dict, lower: bool = False) -> dict:
    li, o, c = data["lineitem"], data["orders"], data["customer"]
    okeys = o["o_orderkey"].long()
    oidx = torch.searchsorted(okeys, li["l_orderkey"].long())
    if not torch.equal(okeys[oidx], li["l_orderkey"].long()):
        raise ValueError("a line's order key is not among the orders")
    wtype = torch.float32 if lower else torch.float64
    qty = li["l_quantity"].to(wtype)
    sums = torch.bincount(oidx, weights=qty, minlength=okeys.shape[0])
    big = sums > params["quantity"]
    lines = big[oidx]
    per_order = torch.bincount(oidx[lines], weights=qty[lines],
                               minlength=okeys.shape[0])
    orders = torch.nonzero(big).flatten()
    ckeys = c["c_custkey"].long()
    cidx = torch.searchsorted(ckeys, o["o_custkey"][orders].long())
    if not torch.equal(ckeys[cidx], o["o_custkey"][orders].long()):
        raise ValueError("an order's customer is not among the customers")
    price = o["o_totalprice"][orders]
    cols = {"c_name": c["c_name"][cidx].long(),
            "c_custkey": ckeys[cidx],
            "o_orderkey": okeys[orders],
            "o_orderdate": o["o_orderdate"][orders].long(),
            "o_totalprice": price.to(wtype).long(),
            "sum_5": per_order[orders].long()}
    # a stable sort by each key from the least significant: the ties of
    # (price, date) by the group columns
    perm = torch.arange(orders.shape[0], device=orders.device)
    for name, desc in [("o_orderkey", False), ("c_custkey", False),
                       ("c_name", False), ("o_orderdate", False),
                       ("o_totalprice", True)]:
        key = cols[name][perm]
        perm = perm[torch.sort(key, stable=True, descending=desc).indices]
    perm = perm[:LIMIT]
    return {k: v[perm] for k, v in cols.items()}
