"""The request generator and the TPC-H and scene generators against the
ranges their sources state."""

import itertools
import json
import os

import pytest
import torch

from qe_bench.common import harness, traffic

KINDS = os.path.join(harness.BENCH, "kinds")


def _mix(name):
    with open(os.path.join(harness.BENCH, "traffic", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["q1", "q6", "q12"])
def test_every_seed_serves_the_same_set(name):
    mix = _mix(name)
    n = traffic.grid_size(mix)
    a = list(itertools.islice(traffic.requests(mix, 1), n))
    b = list(itertools.islice(traffic.requests(mix, 2 ** 33 + 5), n))
    key = lambda p: json.dumps(p, sort_keys=True)  # noqa: E731
    assert len({key(p) for p in a}) == n
    assert sorted(map(key, a)) == sorted(map(key, b)) and a != b
    again = list(itertools.islice(traffic.requests(mix, 1), n))
    assert a == again


def test_substitution_ranges():
    q1 = list(itertools.islice(traffic.requests(_mix("q1"), 3), 61))
    assert sorted(p["delta"] for p in q1) == list(range(60, 121))
    q6 = list(itertools.islice(traffic.requests(_mix("q6"), 3), 80))
    assert {p["discount"] for p in q6} == set(range(2, 10))
    assert all(p["disc_hi"] - p["disc_lo"] == 2 for p in q6)
    assert {p["quantity"] for p in q6} == {24, 25}
    assert {p["year"] for p in q6} == set(range(1993, 1998))
    q12 = list(itertools.islice(traffic.requests(_mix("q12"), 3), 105))
    assert all(0 <= a < b <= 6 for a, b in (p["modes"] for p in q12))
    assert all(p["d1"] - p["d0"] in (365, 366) for p in q12)
    f = list(itertools.islice(traffic.requests(_mix("frame"), 3), 50))
    assert all(len(p["offset"]) == 3 and 0 <= min(p["offset"])
               and max(p["offset"]) < 0.0625 for p in f)


def test_tpch_columns_follow_the_spec():
    tpch = harness.load_module(os.path.join(KINDS, "tpch.py"))
    d = tpch.make_data({"scale_factor": 0.01}, 2 ** 31 + 99, "cpu")
    o, li = d["orders"], d["lineitem"]
    n_o = o["o_orderkey"].shape[0]
    assert n_o == 15000
    k = o["o_orderkey"].long()
    assert torch.equal(k, torch.sort(k).values)
    assert bool(((k - 1) % 32 < 8).all()) and int(k[-1]) == 59976
    assert bool((o["o_custkey"] % 3 != 0).all())
    assert int(o["o_custkey"].min()) >= 1 and int(o["o_custkey"].max()) <= 1500
    lines = torch.bincount(torch.searchsorted(k, li["l_orderkey"].long()),
                           minlength=n_o)
    assert int(lines.min()) == 1 and int(lines.max()) == 7
    assert abs(li["l_orderkey"].shape[0] / n_o - 4) < 0.1

    def within(t, lo, hi):
        return int(t.min()) >= lo and int(t.max()) <= hi
    assert within(o["o_orderdate"], 8035, 10591 - 151)
    assert within(o["o_orderpriority"], 0, 4) and within(o["o_clerk"], 1, 10)
    assert within(li["l_quantity"], 1, 50) and within(li["l_discount"], 0, 10)
    assert within(li["l_tax"], 0, 8) and within(li["l_shipmode"], 0, 6)
    assert within(li["l_shipinstruct"], 0, 3)
    assert within(li["l_partkey"], 1, 2000) and within(li["l_suppkey"], 1, 100)
    pk = li["l_partkey"].long()
    retail = 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)
    assert torch.equal(li["l_extendedprice"].long(),
                       li["l_quantity"].long() * retail)
    od = o["o_orderdate"][torch.searchsorted(k, li["l_orderkey"].long())]
    sd, cd, rd = li["l_shipdate"], li["l_commitdate"], li["l_receiptdate"]
    assert within(sd - od, 1, 121) and within(cd - od, 30, 90)
    assert within(rd - sd, 1, 30)
    assert torch.equal(li["l_linestatus"], (sd > 9298).int())
    late = rd > 9298
    assert bool((li["l_returnflag"][late] == 1).all())
    assert set(li["l_returnflag"][~late].tolist()) == {0, 2}
    status = o["o_orderstatus"]
    assert set(status.tolist()) == {0, 1, 2}
    for name, strings in tpch.CODES.items():    # codes keep string order
        assert list(strings) == sorted(strings), name
        col = (li if name.startswith("l_") else o)[name]
        assert within(col, 0, len(strings) - 1), name


def test_scene_stays_inside_the_box():
    morton = harness.load_module(os.path.join(KINDS, "morton.py"))
    cfg = {"num_vertices": 1000, "num_triangles": 3000, "max_offset": 0.0625}
    d = morton.make_data(cfg, 2 ** 32 + 1, "cpu")
    assert d["verts"].shape == (1000, 3) and d["tris"].shape == (3000, 3)
    assert float(d["verts"].min()) >= 0
    assert float(d["verts"].max()) + 0.0625 <= 1.0
    assert int(d["tris"].min()) >= 0 and int(d["tris"].max()) < 1000
    again = morton.make_data(cfg, 2 ** 32 + 1, "cpu")
    assert torch.equal(d["verts"], again["verts"])
