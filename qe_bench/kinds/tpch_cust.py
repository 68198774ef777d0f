"""TPC-H's eight tables, every column, made on the device from a seed,
served through SQL.

ORDERS and LINEITEM are tpch.make_data's (kinds/tpch.py, unchanged),
byte for byte those of the `tpch` kind at the same seed. Everything else
is drawn after them from a generator of its own, seeded apart, so that
its draws move nothing of theirs: O_COMMENT and L_COMMENT, and CUSTOMER,
PART, SUPPLIER, PARTSUPP, NATION and REGION with the populations of
clause 4.2.3 at scale factor SF (SF * 150,000, 200,000, 10,000 and
800,000 rows; 25 and 5). Encodings (the configuration's ``assumed``),
every column an int32 tensor:

- keys as the spec numbers them; names ("Customer#", "Supplier#" and the
  key zero-padded to 9 digits) as the key, which is their string order;
- money in cents: account balances signed (-99,999 to 999,999), the one
  signed pair of columns, registered as i32; supply cost 100-100,000;
  P_RETAILPRICE by the spec's formula of the partkey;
- strings from the spec's lists as dictionary codes in the strings'
  sort order: segments, nations, regions, P_MFGR (M - 1), P_BRAND
  ((M - 1) * 5 + N - 1), P_TYPE (150) and P_CONTAINER (40);
- phones as the country code's order (the nationkey) in the high bits
  and a random code for the local number below, so that they sort by
  country as their strings do;
- free text (addresses, comments, P_NAME) as random codes.
"""

from __future__ import annotations

import os

import torch

from qe_bench.common.harness import load_module

_tpch = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "tpch.py"))

SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")
# NATION by its key (clause 4.2.3): name and regionkey
NATIONS = (("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
           ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
           ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
           ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
           ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
           ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
           ("UNITED KINGDOM", 3), ("UNITED STATES", 1))
REGIONS = ("AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST")
N_TYPES = 150         # 6 x 5 x 5 syllables, in sort order
N_CONTAINERS = 40     # 5 x 8 syllables, in sort order
SIGNED = ("c_acctbal", "s_acctbal")
OTHER_SEED = 1 << 62  # the generator of all but ORDERS and LINEITEM: + seed
TEXT = 2 ** 31 - 1    # free text's codes lie in [0, TEXT]
LOCAL = 2 ** 25       # a phone's local number code lies below this

fact_rows = _tpch.fact_rows
serve = _tpch.serve
answer_of = _tpch.answer_of


def make_data(cfg: dict, seed: int, device) -> dict:
    """{table: {column: int32 tensor}} for TPC-H's eight tables at the
    configuration's scale factor, drawn from `seed` on `device`."""
    data = _tpch.make_data(cfg, seed, device)
    sf = cfg["scale_factor"]
    nc, npart = int(round(150_000 * sf)), int(round(200_000 * sf))
    ns = int(round(10_000 * sf))
    g = torch.Generator(device=device)
    g.manual_seed(seed + OTHER_SEED)

    def draw(lo: int, hi: int, k: int) -> torch.Tensor:
        """k integers uniform on [lo, hi], int64."""
        return torch.randint(lo, hi + 1, (k,), generator=g, device=device)

    def keys(k: int) -> torch.Tensor:
        return torch.arange(1, k + 1, device=device)

    def phone(nation: torch.Tensor) -> torch.Tensor:
        return nation * LOCAL + draw(0, LOCAL - 1, len(nation))

    def i32(cols: dict) -> dict:
        return {c: v.to(torch.int32).contiguous() for c, v in cols.items()}

    n_orders = len(data["orders"]["o_orderkey"])
    data["orders"]["o_comment"] = draw(0, TEXT, n_orders).to(torch.int32)
    data["lineitem"]["l_comment"] = draw(0, TEXT, fact_rows(data)).to(
        torch.int32)
    c_nation = draw(0, 24, nc)
    data["customer"] = i32({
        "c_custkey": keys(nc), "c_name": keys(nc),
        "c_address": draw(0, TEXT, nc), "c_nationkey": c_nation,
        "c_phone": phone(c_nation), "c_acctbal": draw(-99_999, 999_999, nc),
        "c_mktsegment": draw(0, len(SEGMENTS) - 1, nc),
        "c_comment": draw(0, TEXT, nc)})
    partkey = keys(npart)
    mfgr = draw(0, 4, npart)
    data["part"] = i32({
        "p_partkey": partkey, "p_name": draw(0, TEXT, npart),
        "p_mfgr": mfgr, "p_brand": mfgr * 5 + draw(0, 4, npart),
        "p_type": draw(0, N_TYPES - 1, npart), "p_size": draw(1, 50, npart),
        "p_container": draw(0, N_CONTAINERS - 1, npart),
        "p_retailprice": 90000 + (partkey // 10) % 20001
        + 100 * (partkey % 1000),
        "p_comment": draw(0, TEXT, npart)})
    s_nation = draw(0, 24, ns)
    data["supplier"] = i32({
        "s_suppkey": keys(ns), "s_name": keys(ns),
        "s_address": draw(0, TEXT, ns), "s_nationkey": s_nation,
        "s_phone": phone(s_nation), "s_acctbal": draw(-99_999, 999_999, ns),
        "s_comment": draw(0, TEXT, ns)})
    # four suppliers a part, by clause 4.2.3's PS_SUPPKEY formula (the one
    # kinds/tpch.py draws L_SUPPKEY by)
    pk = partkey.repeat_interleave(4)
    i = torch.arange(4, device=device).repeat(npart)
    data["partsupp"] = i32({
        "ps_partkey": pk,
        "ps_suppkey": (pk + i * (ns // 4 + (pk - 1) // ns)) % ns + 1,
        "ps_availqty": draw(1, 9999, 4 * npart),
        "ps_supplycost": draw(100, 100_000, 4 * npart),
        "ps_comment": draw(0, TEXT, 4 * npart)})
    names = sorted(n for n, _ in NATIONS)
    data["nation"] = i32({
        "n_nationkey": torch.arange(25, device=device),
        "n_name": torch.tensor([names.index(n) for n, _ in NATIONS],
                               device=device),
        "n_regionkey": torch.tensor([r for _, r in NATIONS], device=device),
        "n_comment": draw(0, TEXT, 25)})
    data["region"] = i32({
        "r_regionkey": torch.arange(5, device=device),
        "r_name": torch.arange(len(REGIONS), device=device),
        "r_comment": draw(0, TEXT, 5)})
    return data


def setup(data: dict, device):
    """The program's Database with the eight tables registered as u32
    columns, the account balances as i32, that view the generated
    memory."""
    from tpu_qe_torch.sql.executor import Database
    from tpu_qe_torch.table import Table, from_plane
    db = Database(device)
    for name, cols in data.items():
        db.register(name, Table({
            c: from_plane(v, torch.int32 if c in SIGNED else torch.uint32)
            for c, v in cols.items()}))
    return db
