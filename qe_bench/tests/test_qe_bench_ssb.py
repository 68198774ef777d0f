"""The SSB configuration (configs/ssb-sf20.json, kinds/ssb.py), its mix
(traffic/ssb-q4.1.json), its plain reference (reference/ssb-q4.1.py) and
its cell: the generator against the spec's ranges, the cell end to end at
a tiny size on the CPU, the control and a planted fault caught by the
comparison, and the entries of BENCHMARK.json."""

import itertools
import json
import os
import time

import pytest
import torch

from qe_bench.common import harness, traffic

CELL = "ssb-sf20.q4.1"
TINY_SF = 0.02
SPEC_INSTANCE = {"c_region": 1, "s_region": 1, "mfgr": [0, 1]}


def _cell(sf=TINY_SF):
    cell = harness.load_cell(CELL)
    cell.cfg.update({"scale_factor": sf})
    return cell


@pytest.fixture(scope="module")
def tiny():
    """(kind module, data) at the tiny size on the CPU."""
    cell = _cell()
    return cell.kind, cell.kind.make_data(cell.cfg, 2 ** 31 + 3, "cpu")


def test_sizes_follow_the_spec():
    ssb = _cell().kind
    assert ssb.sizes(20) == {"orders": 30_000_000, "customer": 600_000,
                             "supplier": 40_000, "part": 1_000_000,
                             "date": 2557}
    assert ssb.sizes(1)["part"] == 200_000 and ssb.sizes(8)["part"] \
        == 800_000


def test_every_column_and_key(tiny):
    ssb, d = tiny
    cfg = _cell().cfg
    assert {t: list(c) for t, c in d.items()} == cfg["tables"]
    n = ssb.sizes(TINY_SF)
    for t, key in (("customer", "c_custkey"), ("supplier", "s_suppkey"),
                   ("part", "p_partkey")):
        assert torch.equal(d[t][key].long(),
                           torch.arange(1, n[t] + 1))
    for t in d.values():
        for c in t.values():
            assert c.dtype == torch.int32 and c.is_contiguous()
            assert int(c.min()) >= 0
    lo = d["lineorder"]
    nl = lo["lo_orderkey"].shape[0]
    assert 1 * n["orders"] <= nl <= 7 * n["orders"]
    dk = d["date"]["d_datekey"]
    assert torch.equal(dk, torch.sort(dk).values) and dk.unique().numel() \
        == 2557
    assert int(dk[0]) == 19920101 and int(dk[-1]) == 19981231
    for fk, t in (("lo_custkey", "customer"), ("lo_suppkey", "supplier"),
                  ("lo_partkey", "part")):
        assert 1 <= int(lo[fk].min()) and int(lo[fk].max()) <= n[t]
    for fk in ("lo_orderdate", "lo_commitdate"):
        assert bool(torch.isin(lo[fk], dk).all())
    assert int(lo["lo_orderdate"].max()) <= 19980802


def test_ranges_and_derived_columns(tiny):
    ssb, d = tiny
    lo, c, s, p = (d[t] for t in ("lineorder", "customer", "supplier",
                                  "part"))

    def within(col, lo_, hi):
        return lo_ <= int(col.min()) and int(col.max()) <= hi
    assert within(lo["lo_linenumber"], 1, 7)
    assert within(lo["lo_quantity"], 1, 50)
    assert within(lo["lo_discount"], 0, 10) and within(lo["lo_tax"], 0, 8)
    assert within(lo["lo_orderpriority"], 0, 4)
    assert within(lo["lo_shipmode"], 0, 6)
    assert int(lo["lo_shippriority"].abs().max()) == 0
    k = lo["lo_orderkey"].long()
    assert bool(((k - 1) % 32 < 8).all())
    retail = ssb.retail_cents(lo["lo_partkey"].long())
    price = lo["lo_extendedprice"].long()
    assert torch.equal(price, lo["lo_quantity"].long() * retail)
    assert torch.equal(lo["lo_revenue"].long(),
                       price * (100 - lo["lo_discount"].long()) // 100)
    assert torch.equal(lo["lo_supplycost"].long(), 6 * retail // 10)
    region = torch.tensor([r for _, r in ssb.NATIONS])
    for t, pre in ((c, "c_"), (s, "s_")):
        nation = t[pre + "nation"].long()
        assert within(nation, 0, 24)
        assert torch.equal(t[pre + "region"].long(), region[nation])
        assert torch.equal(t[pre + "city"].long() // 10, nation)
    assert within(p["p_mfgr"], 0, 4) and within(p["p_size"], 1, 50)
    assert torch.equal(p["p_category"] // 5, p["p_mfgr"])
    assert torch.equal(p["p_brand1"] // 40, p["p_category"])
    assert within(p["p_color"], 0, 91) and within(p["p_type"], 0, 149)
    assert within(p["p_container"], 0, 39)
    assert list(ssb.NATIONS) == sorted(ssb.NATIONS)
    assert [sum(r == k for _, r in ssb.NATIONS) for k in range(5)] \
        == [5] * 5


def test_calendar_codes_in_the_strings_order(tiny):
    ssb, d = tiny
    dt = d["date"]
    jan1 = 0
    assert int(dt["d_year"][jan1]) == 1992
    assert int(dt["d_month"][jan1]) == 4          # April, August, ...
    assert int(dt["d_dayofweek"][jan1]) == 6      # Wednesday, the last
    assert int(dt["d_daynuminweek"][jan1]) == 4   # Sunday 1
    assert int(dt["d_weeknuminyear"].max()) == 53
    assert int(dt["d_lastdayinmonthfl"].sum()) == 84
    assert int(dt["d_daynuminyear"].max()) == 366
    assert dt["d_date"].unique().numel() == 2557
    assert dt["d_yearmonth"].unique().numel() == 84


def test_the_grid_holds_the_spec_instance():
    cell = _cell()
    n = traffic.grid_size(cell.mix)
    assert n == 250
    reqs = list(itertools.islice(traffic.requests(cell.mix, 2 ** 40), n))
    assert SPEC_INSTANCE in reqs
    assert all(a < b for a, b in (r["mfgr"] for r in reqs))
    assert "from date, customer, supplier, part, lineorder" in \
        cell.mix["sql"]


@pytest.mark.parametrize("traced", [False, True])
def test_cell_end_to_end(traced, monkeypatch):
    monkeypatch.setattr(harness, "TRACE_SLICE_REQUESTS", 3)
    monkeypatch.setattr(harness, "HOST_SLICE_REQUESTS", 2)
    cell = _cell()
    r = harness.run(cell, 2 ** 31 + 17, 0.5, traced, "cpu",
                    time.perf_counter())
    assert r["correct"] is True, r
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["checks"]["answers_checked"]["value"] == r["attempted"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    if traced:
        # four foreign-key joins of every fact row; the time needs CUDA
        # events (the card test below)
        assert m["ops.join_rows"] == 4.0
        assert m["sort.hostpaced.passes"] > 0
        assert m["sql.hostpaced.syncs"] > 0 and "ops.join_ms" not in m
    else:
        # no peak memory on the CPU
        assert set(m) == {"rows_per_s_hostpaced", "setup_s"}


def test_the_control_is_not_correct():
    cell = _cell(0.05)
    r = harness.run(cell, 11, 0.5, False, "cpu", time.perf_counter(),
                    control=True)
    assert r["correct"] is False
    assert r["checks"]["mismatched_values"]["value"] > 0


def test_a_planted_fault_is_caught(monkeypatch):
    cell = _cell()
    serve = cell.kind.serve

    def off_by_one(db, mix, params):
        return serve(db, mix, dict(params,
                                   c_region=(params["c_region"] + 1) % 5))
    monkeypatch.setattr(cell.kind, "serve", off_by_one)
    r = harness.run(cell, 5, 0.5, False, "cpu", time.perf_counter())
    assert r["correct"] is False and r["failed"] == 0
    assert r["checks"]["mismatched_values"]["value"] > 0


def test_benchmark_entries():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    (conf,) = [c for c in spec["configs"] if c["name"] == "ssb-sf20"]
    assert conf["file"] == "qe_bench/configs/ssb-sf20.json"
    assert conf["reduced"] == [] and len(conf["source"]) <= 200
    (w,) = [w for w in spec["workloads"] if w["name"] == CELL]
    assert (w["config"], w["traffic"], w["chips"]) == (
        "ssb-sf20", "ssb-q4.1", 1)
    cfg = harness.load_cell(CELL).cfg
    assert cfg["kind"] == "ssb" and cfg["scale_factor"] == 20
    assert cfg["reduced"] == {} and cfg["chips"] == 1
    listed = {m["name"] for m in spec["end_to_end"] + spec["per_layer"]
              if CELL in m.get("workloads", [])}
    assert listed == {"rows_per_s_hostpaced", "device.hostpaced.idle_share",
                      "ops.hostpaced.gather_ms",
                      "ops.hostpaced.elementwise_ms", "sort.hostpaced.passes",
                      "kernels.hostpaced.radix_ms", "sql.hostpaced.syncs",
                      "ops.join_ms", "ops.join_rows"}
    for name in ("ops.join_ms", "ops.join_rows"):
        (m,) = [m for m in spec["per_layer"] if m["name"] == name]
        assert m["workloads"] == [CELL]
        assert m["moves"] == "rows_per_s_hostpaced"
        assert os.path.exists(os.path.join(harness.BENCH, "metrics",
                                           name + ".py"))
    for path in ("kinds/ssb.py", "traffic/ssb-q4.1.json",
                 "reference/ssb-q4.1.py"):
        assert os.path.exists(os.path.join(harness.BENCH, path))


@pytest.mark.cuda
def test_join_time_reads_on_the_card(cuda_card, monkeypatch):
    monkeypatch.setattr(harness, "TRACE_SLICE_REQUESTS", 3)
    monkeypatch.setattr(harness, "HOST_SLICE_REQUESTS", 2)
    r = harness.run(_cell(0.5), 2 ** 31 + 17, 1.0, True, cuda_card,
                    time.perf_counter())
    assert r["correct"] is True
    assert r["metrics"]["ops.join_ms"]["value"] > 0
    assert r["metrics"]["ops.join_rows"]["value"] == 4.0
