"""Plain reference of TPC-H Q6 (forecasting revenue change) over the
generated LINEITEM, in torch on the data's device: the exact int64 sum of
extended price (cents) times discount (percent). With ``lower`` the sum
is float32: the control."""

from __future__ import annotations

import numpy as np
import torch


def answer(data: dict, params: dict, lower: bool = False) -> dict:
    li = data["lineitem"]
    sd, disc = li["l_shipdate"], li["l_discount"]
    m = ((sd >= params["d0"]) & (sd < params["d1"])
         & (disc >= params["disc_lo"]) & (disc <= params["disc_hi"])
         & (li["l_quantity"] < params["quantity"]))
    dtype = torch.float32 if lower else torch.int64
    rev = (li["l_extendedprice"][m].to(dtype) * disc[m].to(dtype)).sum()
    return {"revenue": np.array([rev.item()])}
