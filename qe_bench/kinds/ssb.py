"""Star Schema Benchmark tables made on the device from a seed, served
through SQL.

The five tables of O'Neil, O'Neil and Chen, *Star Schema Benchmark*, rev.
3 (2009), §2, every column, at scale factor SF:

- LINEORDER: SF * 1,500,000 orders of 1 to 7 lines each (~SF * 6 M
  rows), sparse order keys (the first 8 of every 32, as TPC-H's);
- CUSTOMER SF * 30,000 rows, SUPPLIER SF * 2,000, PART 200,000 *
  floor(1 + log2 SF) (for SF < 1, the tests' sizes: 200,000 * SF);
- DATE: one row a day from 1992-01-01 to 1998-12-31 (2,557 rows).

Every random number is drawn by torch on the device from one seeded
``torch.Generator``, in a few large calls; the calendar has no draws and
is computed on the host (2,557 rows). Encodings (the configuration's
``assumed``):

- money in cents; discount and tax in percent (0-10, 0-8);
- every string as a dictionary code in the strings' sort order (the
  tuples below: ``REGIONS``, ``NATIONS``, ``SEGMENTS``, ``PRIORITIES``,
  ``SHIPMODES``, ``SEASONS``, and DATE's texts; cities, MFGR, category
  and brand as the text the spec gives them), so that =, ORDER BY and
  GROUP BY keep their meaning; names keep their keys' order, addresses
  and phones are random codes.

``make_data`` returns every column as a contiguous int32 tensor (all
values are below 2^31); ``setup`` registers them with the program as u32
columns viewed from the same memory.
"""

from __future__ import annotations

import datetime
import math

import numpy as np
import torch

REGIONS = ("AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST")
# the 25 nations in sort order, each with its region (TPC-H's NATION)
NATIONS = (("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
           ("CHINA", 2), ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3),
           ("GERMANY", 3), ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4),
           ("IRAQ", 4), ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0),
           ("MOROCCO", 0), ("MOZAMBIQUE", 0), ("PERU", 1), ("ROMANIA", 3),
           ("RUSSIA", 3), ("SAUDI ARABIA", 4), ("UNITED KINGDOM", 3),
           ("UNITED STATES", 1), ("VIETNAM", 2))
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")
PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")
SHIPMODES = ("AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK")
N_COLORS = 92         # TPC-H's P_NAME words; p_color one, p_name two
N_TYPES = 150         # 6 x 5 x 5 syllables, in sort order
N_CONTAINERS = 40     # 5 x 8 syllables, in sort order
FIRST_DAY = datetime.date(1992, 1, 1)
N_DAYS = 2557         # to 1998-12-31
LAST_ORDER_DAY = N_DAYS - 1 - 151   # ENDDATE - 151 days, as TPC-H's
MONTHS = ("January", "February", "March", "April", "May", "June", "July",
          "August", "September", "October", "November", "December")
WEEKDAYS = ("Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
            "Saturday", "Sunday")
# d_sellingseason by month, and its codes in sort order
SEASONS = ("Christmas", "Fall", "Spring", "Summer", "Winter")
SEASON_OF_MONTH = (4, 4, 2, 2, 3, 3, 3, 3, 1, 1, 0, 0)
HOLIDAYS = ((1, 1), (7, 4), (11, 11), (12, 25))    # (month, day)


def sizes(sf: float) -> dict:
    """Rows of the dimension tables and orders at scale factor `sf`."""
    part = 200_000 * max(1, math.floor(1 + math.log2(sf))) if sf >= 1 \
        else 200_000 * sf
    return {"orders": int(round(1_500_000 * sf)),
            "customer": int(round(30_000 * sf)),
            "supplier": int(round(2_000 * sf)), "part": int(round(part)),
            "date": N_DAYS}


def _ranks(strings: list) -> np.ndarray:
    """Each string's place in the sorted list of the distinct strings."""
    order = {s: i for i, s in enumerate(sorted(set(strings)))}
    return np.array([order[s] for s in strings], dtype=np.int64)


def date_table() -> dict:
    """DATE's 17 columns (§2.5) as numpy int64 arrays, one row a day."""
    days = [FIRST_DAY + datetime.timedelta(i) for i in range(N_DAYS)]
    y = np.array([d.year for d in days])
    m = np.array([d.month for d in days])
    dom = np.array([d.day for d in days])
    doy = np.array([d.timetuple().tm_yday for d in days])
    wd = np.array([d.weekday() for d in days])       # Monday 0
    jan1 = np.array([datetime.date(d.year, 1, 1).weekday() for d in days])
    nxt = [d + datetime.timedelta(1) for d in days]
    return {
        "d_datekey": y * 10000 + m * 100 + dom,
        "d_date": _ranks([f"{MONTHS[d.month - 1]} {d.day}, {d.year}"
                          for d in days]),
        "d_dayofweek": _ranks([WEEKDAYS[d.weekday()] for d in days]),
        "d_month": _ranks([MONTHS[d.month - 1] for d in days]),
        "d_year": y,
        "d_yearmonthnum": y * 100 + m,
        "d_yearmonth": _ranks([f"{MONTHS[d.month - 1][:3]}{d.year}"
                               for d in days]),
        "d_daynuminweek": (wd + 1) % 7 + 1,          # Sunday 1
        "d_daynuminmonth": dom,
        "d_daynuminyear": doy,
        "d_monthnuminyear": m,
        "d_weeknuminyear": (doy - 1 + (jan1 + 1) % 7) // 7 + 1,
        "d_sellingseason": np.array([SEASON_OF_MONTH[k - 1] for k in m]),
        "d_lastdayinweekfl": (wd == 5).astype(np.int64),   # Saturday
        "d_lastdayinmonthfl": np.array([int(n.month != d.month)
                                        for d, n in zip(days, nxt)]),
        "d_holidayfl": np.array([int((d.month, d.day) in HOLIDAYS)
                                 for d in days]),
        "d_weekdayfl": (wd < 5).astype(np.int64),
    }


def retail_cents(partkey: torch.Tensor) -> torch.Tensor:
    """P_RETAILPRICE of TPC-H 4.2.3 (SSB §2.3), in cents."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


def make_data(cfg: dict, seed: int, device) -> dict:
    """{table: {column: int32 tensor}} for the five tables at the
    configuration's scale factor, drawn from `seed` on `device`."""
    n = sizes(cfg["scale_factor"])
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def draw(lo: int, hi: int, k: int) -> torch.Tensor:
        """k integers uniform on [lo, hi], int64."""
        return torch.randint(lo, hi + 1, (k,), generator=g, device=device)

    def keys(k: int) -> torch.Tensor:
        return torch.arange(1, k + 1, device=device)

    def i32(cols: dict) -> dict:
        return {c: v.to(torch.int32).contiguous() for c, v in cols.items()}

    region = torch.tensor([r for _, r in NATIONS], device=device)

    def place(k: int) -> dict:
        """Nation, city (the nation's first 9 letters and a digit, so
        nation * 10 + digit in sort order) and region of k rows."""
        nation = draw(0, 24, k)
        return {"nation": nation, "city": nation * 10 + draw(0, 9, k),
                "region": region[nation]}

    nc = n["customer"]
    c = place(nc)
    customer = i32({
        "c_custkey": keys(nc), "c_name": keys(nc),
        "c_address": draw(0, 2 ** 31 - 1, nc), "c_city": c["city"],
        "c_nation": c["nation"], "c_region": c["region"],
        "c_phone": draw(0, 2 ** 31 - 1, nc),
        "c_mktsegment": draw(0, len(SEGMENTS) - 1, nc)})
    ns = n["supplier"]
    s = place(ns)
    supplier = i32({
        "s_suppkey": keys(ns), "s_name": keys(ns),
        "s_address": draw(0, 2 ** 31 - 1, ns), "s_city": s["city"],
        "s_nation": s["nation"], "s_region": s["region"],
        "s_phone": draw(0, 2 ** 31 - 1, ns)})
    npart = n["part"]
    mfgr = draw(0, 4, npart)
    category = mfgr * 5 + draw(0, 4, npart)
    part = i32({
        "p_partkey": keys(npart),
        "p_name": draw(0, N_COLORS - 1, npart) * N_COLORS
        + draw(0, N_COLORS - 1, npart),
        "p_mfgr": mfgr, "p_category": category,
        "p_brand1": category * 40 + draw(0, 39, npart),
        "p_color": draw(0, N_COLORS - 1, npart),
        "p_type": draw(0, N_TYPES - 1, npart), "p_size": draw(1, 50, npart),
        "p_container": draw(0, N_CONTAINERS - 1, npart)})
    date = {k: torch.from_numpy(v).to(device)
            for k, v in date_table().items()}
    datekey = date["d_datekey"]
    date = i32(date)

    no = n["orders"]
    i = torch.arange(no, device=device)
    orderkey = (i // 8) * 32 + i % 8 + 1
    custkey = draw(1, nc, no)
    orderday = draw(0, LAST_ORDER_DAY, no)
    priority = draw(0, len(PRIORITIES) - 1, no)
    lines = draw(1, 7, no)
    nl = int(lines.sum())
    oidx = torch.repeat_interleave(i, lines, output_size=nl)
    del i
    first = torch.cumsum(lines, 0) - lines
    lo = {"lo_orderkey": orderkey[oidx],
          "lo_linenumber": torch.arange(nl, device=device) - first[oidx] + 1,
          "lo_custkey": custkey[oidx]}
    lo = i32(lo)
    pk = draw(1, npart, nl)
    retail = retail_cents(pk)
    quantity = draw(1, 50, nl)
    price = quantity * retail
    discount = draw(0, 10, nl)
    tax = draw(0, 8, nl)
    charge = price * (100 + tax) * (100 - discount) // 10000
    total = torch.zeros(no, dtype=torch.int64, device=device)
    total.index_add_(0, oidx, charge)
    del charge
    oday = orderday[oidx]
    lo.update(i32({
        "lo_partkey": pk, "lo_suppkey": draw(1, ns, nl),
        "lo_orderdate": datekey[oday],
        "lo_orderpriority": priority[oidx],
        "lo_shippriority": torch.zeros(nl, dtype=torch.int64,
                                       device=device),
        "lo_quantity": quantity, "lo_extendedprice": price,
        "lo_ordtotalprice": total[oidx], "lo_discount": discount,
        "lo_revenue": price * (100 - discount) // 100,
        "lo_supplycost": 6 * retail // 10, "lo_tax": tax,
        "lo_commitdate": datekey[oday + draw(30, 90, nl)],
        "lo_shipmode": draw(0, len(SHIPMODES) - 1, nl)}))
    lineorder = {name: lo[name] for name in LINEORDER_COLUMNS}
    return {"date": date, "customer": customer, "supplier": supplier,
            "part": part, "lineorder": lineorder}


LINEORDER_COLUMNS = (
    "lo_orderkey", "lo_linenumber", "lo_custkey", "lo_partkey",
    "lo_suppkey", "lo_orderdate", "lo_orderpriority", "lo_shippriority",
    "lo_quantity", "lo_extendedprice", "lo_ordtotalprice", "lo_discount",
    "lo_revenue", "lo_supplycost", "lo_tax", "lo_commitdate",
    "lo_shipmode")


def fact_rows(data: dict) -> int:
    """Rows of LINEORDER, which every query of the mix reads."""
    return data["lineorder"]["lo_orderkey"].shape[0]


def setup(data: dict, device):
    """The program's Database with the five tables registered as u32
    columns that view the generated memory."""
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
