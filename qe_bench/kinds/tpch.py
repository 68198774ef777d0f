"""TPC-H tables made on the device from a seed, served through SQL.

The columns follow the TPC-H specification v3, clause 4.2.3, at scale
factor SF: ORDERS has SF * 1,500,000 rows with sparse keys (the first 8 of
every 32), each order 1 to 7 LINEITEM rows. Every number is drawn by
torch on the device from one seeded ``torch.Generator``, in a few large
calls. Encodings (the configuration's ``assumed``):

- money in cents, discount and tax in percent (0-10, 0-8);
- dates as days since 1970-01-01;
- the short strings as dictionary codes in the strings' sort order
  (``CODES``), so that ORDER BY, = and IN keep their meaning.

``make_data`` returns every column as a contiguous int32 tensor (all
values are below 2^31). ``setup`` registers them with the program as u32
columns viewed from the same memory, so the program and the reference
read the same bytes and nothing is copied to the host.
"""

from __future__ import annotations

import torch

# day numbers (days since 1970-01-01) of the dates the spec names
STARTDATE = 8035          # 1992-01-01
ENDDATE = 10591           # 1998-12-31
CURRENTDATE = 9298        # 1995-06-17

CODES = {
    "l_returnflag": ("A", "N", "R"),
    "l_linestatus": ("F", "O"),
    "l_shipinstruct": ("COLLECT COD", "DELIVER IN PERSON", "NONE",
                       "TAKE BACK RETURN"),
    "l_shipmode": ("AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP",
                   "TRUCK"),
    "o_orderpriority": ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
                        "5-LOW"),
    "o_orderstatus": ("F", "O", "P"),
}


def make_data(cfg: dict, seed: int, device) -> dict:
    """{"orders": {col: int32}, "lineitem": {col: int32}} at the
    configuration's scale factor, drawn from `seed` on `device`."""
    sf = cfg["scale_factor"]
    n_orders = int(round(1_500_000 * sf))
    n_cust, n_part = int(round(150_000 * sf)), int(round(200_000 * sf))
    n_supp, n_clerk = int(round(10_000 * sf)), int(round(1_000 * sf))
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def draw(lo: int, hi: int, n: int) -> torch.Tensor:
        """n integers uniform on [lo, hi], int64."""
        return torch.randint(lo, hi + 1, (n,), generator=g, device=device)

    i = torch.arange(n_orders, device=device)
    o_orderkey = (i // 8) * 32 + i % 8 + 1
    k = draw(0, n_cust - n_cust // 3 - 1, n_orders)
    o_custkey = k + k // 2 + 1                    # skips multiples of 3
    o_orderdate = draw(STARTDATE, ENDDATE - 151, n_orders)
    o_orderpriority = draw(0, 4, n_orders)
    o_clerk = draw(1, n_clerk, n_orders)
    lines = draw(1, 7, n_orders)
    n = int(lines.sum())
    oidx = torch.repeat_interleave(i, lines, output_size=n)
    first = torch.cumsum(lines, 0) - lines
    l_linenumber = torch.arange(n, device=device) - first[oidx] + 1
    l_orderkey = o_orderkey[oidx]
    pk = draw(1, n_part, n)
    supp_i = draw(0, 3, n)
    l_suppkey = (pk + supp_i * (n_supp // 4 + (pk - 1) // n_supp)) \
        % n_supp + 1
    l_quantity = draw(1, 50, n)
    retail_cents = 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)
    l_extendedprice = l_quantity * retail_cents
    l_discount = draw(0, 10, n)
    l_tax = draw(0, 8, n)
    odate = o_orderdate[oidx]
    l_shipdate = odate + draw(1, 121, n)
    l_commitdate = odate + draw(30, 90, n)
    l_receiptdate = l_shipdate + draw(1, 30, n)
    l_linestatus = (l_shipdate > CURRENTDATE).long()          # F=0, O=1
    ra = draw(0, 1, n) * 2                                    # A=0, R=2
    l_returnflag = torch.where(l_receiptdate <= CURRENTDATE, ra, 1)  # N=1
    l_shipinstruct = draw(0, 3, n)
    l_shipmode = draw(0, 6, n)
    charge = l_extendedprice * (100 + l_tax) * (100 - l_discount) // 10000
    o_totalprice = torch.zeros(n_orders, dtype=torch.int64, device=device)
    o_totalprice.index_add_(0, oidx, charge)
    n_f = torch.zeros(n_orders, dtype=torch.int64, device=device)
    n_f.index_add_(0, oidx, 1 - l_linestatus)
    o_orderstatus = torch.where(n_f == lines, 0,
                                torch.where(n_f == 0, 1, 2))  # F, O, P

    def i32(cols: dict) -> dict:
        return {name: c.to(torch.int32).contiguous()
                for name, c in cols.items()}

    orders = i32({
        "o_orderkey": o_orderkey, "o_custkey": o_custkey,
        "o_orderstatus": o_orderstatus, "o_totalprice": o_totalprice,
        "o_orderdate": o_orderdate, "o_orderpriority": o_orderpriority,
        "o_clerk": o_clerk,
        "o_shippriority": torch.zeros_like(o_orderkey)})
    lineitem = i32({
        "l_orderkey": l_orderkey, "l_partkey": pk, "l_suppkey": l_suppkey,
        "l_linenumber": l_linenumber, "l_quantity": l_quantity,
        "l_extendedprice": l_extendedprice, "l_discount": l_discount,
        "l_tax": l_tax, "l_returnflag": l_returnflag,
        "l_linestatus": l_linestatus, "l_shipdate": l_shipdate,
        "l_commitdate": l_commitdate, "l_receiptdate": l_receiptdate,
        "l_shipinstruct": l_shipinstruct, "l_shipmode": l_shipmode})
    return {"orders": orders, "lineitem": lineitem}


def fact_rows(data: dict) -> int:
    """Rows of the fact input every query of these mixes reads."""
    return data["lineitem"]["l_orderkey"].shape[0]


def setup(data: dict, device):
    """The program's Database with both tables registered as u32 columns
    that view the generated memory."""
    from tpu_qe_torch.sql.executor import Database
    from tpu_qe_torch.table import Table, from_plane
    db = Database(device)
    for name, cols in data.items():
        db.register(name, Table({c: from_plane(v, torch.uint32)
                                 for c, v in cols.items()}))
    return db


def serve(db, mix: dict, params: dict) -> dict:
    """One query of the mix, its text filled in from `params`, its result
    read back as {column: numpy array}."""
    return db.sql(mix["sql"].format(**params))


def answer_of(result: dict) -> dict:
    return result
