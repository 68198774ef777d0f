"""examples/analytics_torch.py and tools/verb_battery_torch.py, the port's
twins of examples/analytics.py and tools/verb_battery.py, on the CPU.

The walkthrough runs once at 16384 events (`main(["--n", "16384",
"--device", "cpu"])`); each step's returned result is held against the
same tpu_qe functions on the same inputs (the morton keys, the filter
count, the join, the GROUP BY table, the top-k, the fused join's sums, the
distributed sort, the out-of-core GROUP BY, the windows, the ORDER BY, the
distinct counts and medians, the set op, and both SQL steps bit for bit;
the mean at float32's rtol 1e-6; the SQL columns also of the same
dtypes). Then both twins run in a fresh process
whose imports of `jax` and `tpu_qe` raise, the battery at a small size.
"""

import functools
import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
N = 16384


def _load(rel):
    spec = importlib.util.spec_from_file_location(
        rel.replace("/", "_")[:-3], ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # under pytest-xdist several test processes share the CPU's cores:
    # torch's own thread pool on top of them only makes its ops wait
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _port():
    return _load("examples/analytics_torch.py").main(
        ["--n", str(N), "--device", "cpu"])


@functools.lru_cache(maxsize=None)
def _jax():
    """The reference walkthrough's steps through tpu_qe on the same
    inputs: {step: the values the port's step returns}."""
    import jax.numpy as jnp
    from tpu_qe import morton
    from tpu_qe.bits import U64
    from tpu_qe.table import Table
    ev_np = _load("examples/analytics_torch.py").events(N)
    out = {}
    params = morton.MortonParams.for_scene(
        np.array([-100.0] * 3, np.float32), np.array([100.0] * 3, np.float32))
    fine = morton.encode_points(jnp.asarray(ev_np["x"]),
                                jnp.asarray(ev_np["y"]),
                                jnp.asarray(ev_np["z"]), params)
    out["morton"] = {"keys": fine.to_numpy()}
    cell = U64(jnp.zeros_like(fine.lo), fine.hi & jnp.uint32(0xFFF00000))
    coarse = Table({"cell": cell, "value": jnp.asarray(ev_np["value"]),
                    "sensor": Table.from_numpy(
                        {"s": ev_np["sensor"]})["s"]})
    filtered, kept = coarse.filter(lambda t: t["value"] > jnp.uint32(20))
    kept = int(kept)
    ev = filtered.head(kept)
    out["filter"] = {"kept": kept}
    sensors = Table.from_numpy({
        "sensor": np.arange(1024, dtype=np.uint64),
        "gain": np.arange(1024, dtype=np.uint32) % 7 + 1})
    joined, matched = ev.join(sensors, key="sensor")
    out["join"] = {"matched": int(np.asarray(matched).sum())}
    res = joined.group_by("cell", value="gain", aggs=("count", "sum", "mean"))
    g = int(res.num_groups)
    out["group_by"] = {
        "groups": g, "mean0": float(np.asarray(res.aggs["mean"])[0]),
        "cells": res.key.to_numpy()[:g],
        "count": np.asarray(res.aggs["count"])[:g],
        "sum": res.aggs["sum"].to_numpy()[:g]}
    cnt = res.aggs["count"]
    cells = Table({"key": U64(cnt, jnp.zeros_like(cnt)),
                   "cell_hi": res.key.hi}).head(g)
    out["top_k"] = {"top": cells.top_k(5, largest=True).table.to_numpy()[
        "key"][:5]}
    from tpu_qe.ops.aggregate import group_aggregate_sorted
    from tpu_qe.ops.join import join_fk_scan
    st = join_fk_scan(Table({"z": jnp.zeros(kept, jnp.uint32)}),
                      sensors.drop("sensor"), ev["sensor"],
                      sensors["sensor"], output="stream")
    agg = group_aggregate_sorted(st.key, st.values["gain"],
                                 aggs=("count", "sum"), valid=st.matched)
    ng = int(agg.num_groups)
    out["fused"] = {"sensors": ng,
                    "total": int(agg.aggs["sum"].to_numpy()[:ng].sum())}
    from tpu_qe.exchange import distributed_sort_numpy, make_mesh
    keys = out["morton"]["keys"]
    out["dsort"] = {"keys": distributed_sort_numpy(
        keys, None, make_mesh(8), capacity_factor="auto")}
    from tpu_qe.ops.bigagg import aggregate_big
    out["bigagg"] = {"groups": aggregate_big(
        1 << 16, n_groups=1 << 10, run_size=1 << 14, minmax=True).n_groups}
    w = ev.window("sensor", {"seq": ("row_number",),
                             "cum_val": ("running_sum", "value"),
                             "prev_val": ("lag", "value")},
                  order="value").to_numpy()
    out["window"] = {k: w[k] for k in ("seq", "cum_val", "prev_val")}
    srt = ev.order_by("sensor", ("value", "desc")).to_numpy()
    out["order_by"] = {k: srt[k] for k in ("sensor", "value", "cell")}
    cd = ev.group_by("sensor", "value", aggs=("count", "count_distinct"))
    ncd = int(cd.num_groups)
    qres = ev.group_quantile("sensor", "value", [0.5, 0.99])
    out["distinct"] = {
        "sensors": ncd,
        "count_distinct": np.asarray(cd.aggs["count_distinct"])[:ncd],
        "quantiles": np.asarray(qres.quantiles)[:, :ncd]}
    half = ev.num_rows // 2
    first = Table({"key": U64(ev["sensor"].lo[:half],
                              ev["sensor"].hi[:half])})
    second = Table({"key": U64(ev["sensor"].lo[half:],
                               ev["sensor"].hi[half:])})
    ikeys, _, _, inum = first.set_op(second, "intersect")
    out["set_op"] = {"both": int(inum),
                     "keys": ikeys.to_numpy()[:int(inum)]}
    from tpu_qe.hashing import murmur_fmix32
    from tpu_qe.sql import Database
    sql = _load("examples/analytics_torch.py").SQL
    db = Database()
    db.register("events", Table({"sensor": ev["sensor"].lo,
                                 "value": ev["value"]}))
    out["sql"] = {"rows": db.sql(sql),
                  "mesh_rows": db.sql(sql, mesh=make_mesh(8))}
    db.register_virtual("big", (1 << 16) + 17, {
        "k": lambda i: murmur_fmix32(i) & jnp.uint32(255),
        "v": lambda i: i})
    out["bigsql"] = {"rows": db.sql(
        "SELECT k, COUNT(*) AS c, SUM(v) AS s FROM big GROUP BY k",
        run_size=1 << 14)}
    return out


STEPS = ["morton", "filter", "join", "group_by", "top_k", "fused", "dsort",
         "bigagg", "window", "order_by", "distinct", "set_op", "sql",
         "bigsql"]


def _same(got, want, what):
    """Equal values; SQL result columns (`rows`) also of equal dtypes (the
    operators' count columns are the port's int64 where JAX has uint32)."""
    if isinstance(want, dict):
        assert list(got) == list(want), what
        for k in want:
            _same(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=what)
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        if "rows" in what:
            assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, what


def test_the_walkthrough_prints_every_step():
    got = _port()
    assert list(got) == STEPS
    assert all(isinstance(got[s]["line"], str) for s in STEPS)


@pytest.mark.parametrize("step", STEPS)
def test_step_matches_jax(step):
    got, want = _port()[step], _jax()[step]
    _same({k: got[k] for k in want}, want, step)


def _blocked(script: str) -> str:
    """Code that runs `script` as __main__ with every import of jax or
    tpu_qe raising."""
    return ("import importlib.abc, runpy, sys\n"
            "class Block(importlib.abc.MetaPathFinder):\n"
            "    def find_spec(self, name, path, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'tpu_qe'):\n"
            "            raise ImportError(f'{name} imported')\n"
            "sys.meta_path.insert(0, Block())\n"
            f"sys.argv[0] = {script!r}\n"
            f"runpy.run_path({script!r}, run_name='__main__')\n")


@pytest.mark.parametrize("script,args", [
    ("examples/analytics_torch.py", ["--n", "4096", "--device", "cpu"]),
    ("tools/verb_battery_torch.py", ["--n", "65536", "--run-size", "4096",
                                     "--groups", "16", "--device", "cpu"]),
])
def test_twins_import_no_jax(script, args):
    r = subprocess.run([sys.executable, "-c", _blocked(str(ROOT / script))]
                       + args, capture_output=True, text=True, timeout=300,
                       cwd=str(ROOT), env={**os.environ,
                                           "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert "imported" not in r.stderr
    if script.startswith("tools"):
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
        assert len(lines) == 9 and all('"verified": true' in ln
                                       for ln in lines)
    else:
        assert r.stdout.rstrip().endswith("done.")
