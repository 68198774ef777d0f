"""Plain reference of SSB Q4.1 (profit by year and customer nation) over
the generated star schema, in torch on the data's device.

Each dimension attribute is looked up by its dense key: CUSTOMER, SUPPLIER
and PART by key - 1, DATE through a table indexed by the yyyymmdd key
less the first; a key that finds no row raises. The three predicates make
one mask over LINEORDER, and the profit is an exact int64 ``index_add``
over (year, nation). The groups come out in (d_year, c_nation) order.
With ``lower`` the sums are float32: the control."""

from __future__ import annotations

import numpy as np
import torch

N_NATIONS = 25


def _by_key(keys: torch.Tensor, fk: torch.Tensor) -> torch.Tensor:
    """Row index of each foreign key in a dimension whose keys are
    1..n in row order."""
    n = keys.shape[0]
    if not torch.equal(keys.long(), torch.arange(1, n + 1,
                                                 device=keys.device)):
        raise ValueError("a dimension's keys are not 1..n in row order")
    idx = fk.long() - 1
    if bool(((idx < 0) | (idx >= n)).any()):
        raise ValueError("a foreign key finds no dimension row")
    return idx


def answer(data: dict, params: dict, lower: bool = False) -> dict:
    lo, c, s, p, d = (data[t] for t in ("lineorder", "customer", "supplier",
                                        "part", "date"))
    cust = _by_key(c["c_custkey"], lo["lo_custkey"])
    m = ((c["c_region"][cust] == params["c_region"])
         & (s["s_region"][_by_key(s["s_suppkey"], lo["lo_suppkey"])]
            == params["s_region"]))
    mfgr = p["p_mfgr"][_by_key(p["p_partkey"], lo["lo_partkey"])]
    m &= (mfgr == params["mfgr"][0]) | (mfgr == params["mfgr"][1])
    dkey = d["d_datekey"].long()
    first = int(dkey.min())
    year_of = torch.full((int(dkey.max()) - first + 1,), -1,
                         dtype=torch.int64, device=dkey.device)
    year_of[dkey - first] = d["d_year"].long()
    odate = lo["lo_orderdate"][m].long() - first
    if bool(((odate < 0) | (odate >= year_of.shape[0])).any()):
        raise ValueError("an order date finds no DATE row")
    year = year_of[odate]
    if bool((year < 0).any()):
        raise ValueError("an order date finds no DATE row")
    y0 = int(d["d_year"].min())
    n_years = int(d["d_year"].max()) - y0 + 1
    group = (year - y0) * N_NATIONS + c["c_nation"][cust[m]].long()
    dtype = torch.float32 if lower else torch.int64
    profit = lo["lo_revenue"][m].to(dtype) - lo["lo_supplycost"][m].to(dtype)
    sums = torch.zeros(n_years * N_NATIONS, dtype=dtype, device=m.device)
    sums.index_add_(0, group, profit)
    count = torch.bincount(group, minlength=n_years * N_NATIONS)
    present = np.flatnonzero(count.cpu().numpy())
    return {"d_year": (y0 + present // N_NATIONS).astype(np.uint32),
            "c_nation": (present % N_NATIONS).astype(np.uint32),
            "profit": sums.cpu().numpy()[present]}
