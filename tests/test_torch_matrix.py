"""tpu_qe_torch.bench.matrix on CPU tensors: each config's operator against
the body of the same config in tpu_qe/bench/matrix.py, fed the same numpy
data (the port makes its own data with torch.Generators, whose numbers
differ from jax.random's), plus a rehearsal of the bench-matrix CLI at a
tiny scale (its checks run; no time is measured on the CPU) and the
port's envelope model. Tolerance: exact equality.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_qe.bits import U64 as JU64  # noqa: E402
from tpu_qe.ops.aggregate import (group_aggregate as jga,  # noqa: E402
                                  group_aggregate_sorted as jgas)
from tpu_qe.ops.join import join_fk_scan as jfk  # noqa: E402
from tpu_qe.table import Table as JTable  # noqa: E402
from tpu_qe_torch.__main__ import main  # noqa: E402
from tpu_qe_torch.bench import matrix, sol  # noqa: E402
from tpu_qe_torch.bits import U64  # noqa: E402
from tpu_qe_torch.sort import driver  # noqa: E402
from tpu_qe_torch.sort.planes import num_passes, sort_planes  # noqa: E402
from tpu_qe_torch.table import from_plane  # noqa: E402

GOLDEN = np.uint32(2654435761)


def _u32(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.uint32).view(np.int32))


def _same_groups(res, jres):
    ng = int(jres.num_groups)
    assert int(res.num_groups) == ng > 0
    np.testing.assert_array_equal(res.key.to_numpy()[:ng],
                                  jres.key.to_numpy()[:ng])
    np.testing.assert_array_equal(res.aggs["count"].numpy()[:ng],
                                  np.asarray(jres.aggs["count"])[:ng])
    np.testing.assert_array_equal(res.aggs["sum"].to_numpy()[:ng],
                                  jres.aggs["sum"].to_numpy()[:ng])


@pytest.mark.parametrize("backend", ["radix", "torch"])
def test_filter_agg_matches_the_jax_config(backend):
    rng = np.random.default_rng(7)
    n, groups = 20_000, 1 << 10
    gid = rng.integers(0, groups, n).astype(np.uint32)
    lo, hi = gid * GOLDEN, gid >> np.uint32(13)
    val = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    data = {"key": U64(_u32(lo), _u32(hi)),
            "val": from_plane(_u32(val), torch.uint32)}
    res, valid = matrix.filter_agg_op(data, backend)
    jres = jga(JU64(jnp.asarray(lo), jnp.asarray(hi)), jnp.asarray(val),
               aggs=("count", "sum"),
               valid=jnp.asarray(val) < jnp.uint32(1 << 30))
    _same_groups(res, jres)
    assert int(valid.sum()) == int((val < (1 << 30)).sum())


def _join_np(n, groups, seed):
    rng = np.random.default_rng(seed)
    r = np.arange(n, dtype=np.uint32)
    rlo, rhi = (r * GOLDEN) ^ np.uint32(0x9E3779B9), r
    rval = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    pick = rng.integers(0, groups, n)
    data = {"rkey": U64(_u32(rlo), _u32(rhi)),
            "rval": from_plane(_u32(rval), torch.uint32),
            "pick": torch.from_numpy(pick),
            "lkey": U64(_u32(rlo[pick]), _u32(rhi[pick]))}
    jdata = (JU64(jnp.asarray(rlo[pick]), jnp.asarray(rhi[pick])),
             JU64(jnp.asarray(rlo), jnp.asarray(rhi)), jnp.asarray(rval))
    return data, jdata


@pytest.mark.parametrize("backend", ["radix", "torch"])
def test_join_matches_the_jax_config(backend):
    n = 5000
    data, (lkey, rkey, rval) = _join_np(n, n, 3)
    out, matched = matrix.join_op(data, backend)
    jout, jm = jfk(JTable({"li": jnp.arange(n, dtype=jnp.uint32)}),
                   JTable({"rval": rval}), lkey, rkey)
    np.testing.assert_array_equal(matched.numpy(), np.asarray(jm))
    assert bool(matched.all())
    for nm in ("li", "rval"):
        np.testing.assert_array_equal(
            out[nm].view(torch.int32).numpy().view(np.uint32),
            np.asarray(jout[nm]))


@pytest.mark.parametrize("fused", [False, True])
def test_join_agg_matches_the_jax_config(fused):
    n = 6400
    data, (lkey, rkey, rval) = _join_np(n, n // 64, 9)
    res = matrix.join_agg_op(data, "radix", fused)
    z = JTable({"z": jnp.zeros(n, jnp.uint32)})
    if fused:
        st = jfk(z, JTable({"rval": rval}), lkey, rkey, output="stream")
        jres = jgas(st.key, st.values["rval"], aggs=("count", "sum"),
                    valid=st.matched)
    else:
        out, m = jfk(z, JTable({"rval": rval}), lkey, rkey)
        jres = jga(lkey, out["rval"], aggs=("count", "sum"), valid=m)
    _same_groups(res, jres)


@pytest.mark.parametrize("backend", ["radix", "torch"])
def test_window_matches_the_jax_config(backend):
    import importlib
    jw = importlib.import_module("tpu_qe.ops.window")
    rng = np.random.default_rng(13)
    n = 6000
    pid = rng.integers(0, 1 << 7, n).astype(np.uint32)
    lo, hi = pid * GOLDEN, pid >> np.uint32(9)
    order = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    order[::3] = order[::3] & np.uint32(0xF)           # ties
    val = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    data = {"key": U64(_u32(lo), _u32(hi)),
            "order": from_plane(_u32(order), torch.uint32),
            "val": from_plane(_u32(val), torch.uint32)}
    for funcs in matrix.WINDOW_FUNCS:
        res = matrix.window_op(data, funcs, backend)
        jres = jw.window(JU64(jnp.asarray(lo), jnp.asarray(hi)), funcs,
                         order=jnp.asarray(order),
                         values={"v": jnp.asarray(val)})
        for name, c in res.cols.items():
            want = jres.cols[name]
            got = c.to_numpy() if isinstance(c, U64) else (
                c.view(torch.int32).numpy().view(np.uint32))
            np.testing.assert_array_equal(
                got, want.to_numpy() if isinstance(want, JU64)
                else np.asarray(want), err_msg=name)


@pytest.mark.parametrize("backend", ["radix", "torch"])
def test_quantile_matches_the_jax_config(backend):
    from tpu_qe.ops.quantile import group_quantile as jgq
    rng = np.random.default_rng(23)
    n, groups = 6000, 1 << 6
    gid = rng.integers(0, groups, n).astype(np.uint32)
    lo, hi = gid * GOLDEN, gid >> np.uint32(7)
    val = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    data = {"key": U64(_u32(lo), _u32(hi)),
            "val": from_plane(_u32(val), torch.uint32), "groups": groups}
    res = matrix.quantile_op(data, backend)
    jres = jgq(JU64(jnp.asarray(lo), jnp.asarray(hi)), jnp.asarray(val),
               matrix.QUANTILES, max_groups=groups)
    ng = int(jres.num_groups)
    assert int(res.num_groups) == ng and int(res.overflow) == 0
    np.testing.assert_array_equal(res.key.to_numpy()[:ng],
                                  jres.key.to_numpy()[:ng])
    np.testing.assert_array_equal(
        res.quantiles.view(torch.int32).numpy().view(np.uint32)[:, :ng],
        np.asarray(jres.quantiles)[:, :ng])
    np.testing.assert_array_equal(res.count.numpy()[:ng],
                                  np.asarray(jres.count)[:ng])


def test_bench_matrix_cli_rehearses_every_config_on_the_cpu(capsys):
    assert main(["bench-matrix", "--device", "cpu", "--scale", "0.00005",
                 "--configs", ",".join(matrix.BUILDERS)]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r["config"] for r in rows] == [
        "pipeline", "filter_agg", "join", "join_agg", "join_agg", "orderby",
        "count_distinct", "setop", "window", "window", "quantile", "dsort"]
    for r in rows:
        assert all(r["checks"].values()), r
        assert r["time_s"] == "not measured" and r["device"] == "cpu"
    passes = {r["metric"]: r["sort_passes"] for r in rows}
    assert list(passes.values()) == [8, 9, 8, 17, 8, 16, 12, 8, 12, 12, 12,
                                     8]


@pytest.mark.parametrize("config", ["window", "quantile", "dsort", "nope"])
def test_unported_configs_exit_nonzero(config, capsys):
    # every config is ported: dsort runs at a small scale on a LocalMesh
    # of 4 CPU shards; nope (unknown) exits on its own, and window and
    # quantile named beside it exit before any config runs
    if config == "dsort":
        assert main(["bench-matrix", "--device", "cpu", "--scale", "0.001",
                     "--configs", "dsort", "--devices", "4"]) == 0
        (row,) = [json.loads(line) for line in
                  capsys.readouterr().out.splitlines()
                  if line.startswith("{")]
        assert all(row["checks"].values()), row
        assert row["devices"] == 4 and 1 <= row["balance"] < 1.5, row
        return
    configs = config if config == "nope" else f"{config},nope"
    with pytest.raises(SystemExit) as e:
        main(["bench-matrix", "--device", "cpu", "--configs", configs])
    assert e.value.code not in (0, None)
    assert "{" not in capsys.readouterr().out


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError):
        main(["bench-matrix", "--configs", "join", "--scale", "0.0001"])


def test_filter_agg_data_keeps_a_quarter_of_the_rows():
    data = matrix.filter_agg_data(1 << 16, "cpu", groups=1 << 8)
    _, valid = matrix.filter_agg_op(data, "torch")
    assert 0.23 < float(valid.float().mean()) < 0.27
    assert data["key"].lo.dtype == torch.int32
    assert data["val"].dtype == torch.uint32


def test_envelope_counts_the_radix_passes_and_scans():
    name = "NVIDIA H100 80GB HBM3"
    n = 5000
    planes = [_u32(np.arange(n) % 2), _u32(np.arange(n)[::-1]),
              _u32(np.arange(n) * 7)]
    driver.RADIX_PASSES.clear()
    sort_planes(planes, 3, [1, 32, 32])
    # eight 8-byte-key passes and one 1-bit pass of the lone flag plane,
    # each carrying the row permutation
    assert driver.RADIX_PASSES == {(n, 8, 1): 8, (n, 4, 1): 1}
    assert num_passes(3, [1, 32, 32]) == 9
    t = sol.operator_sol_seconds(driver.RADIX_PASSES, 3, n, device_name=name)
    # 8 + 4 B and 4 + 4 B per row, in and out; 8 B per row per scan
    assert t == pytest.approx((8 * 24 * n + 16 * n + 24 * n) / 3.35e12)
    with pytest.raises(ValueError):
        sol.operator_sol_seconds({(n, 8, 1): 8}, 0, n, device_name="TPU v5")


def test_bench_matrix_trace_dir_profiles_one_more_radix_run(tmp_path,
                                                            capsys):
    assert main(["bench-matrix", "--device", "cpu", "--scale", "0.00005",
                 "--configs", "join_agg", "--trace-dir", str(tmp_path)]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert len(rows) == 2
    for i, r in enumerate(rows):
        prof = r["profile"]
        assert prof["trace"] == str(tmp_path / f"join_agg-{i}.json")
        assert (tmp_path / f"join_agg-{i}.json").stat().st_size > 0
        assert prof["idle_share"] == "not measured" and prof["wall_ms"] > 0
        assert r["radix_runs"] == 2


@pytest.mark.parametrize("kernel,category", [
    ("void (anonymous namespace)::histogram_kernel<true, false>(unsigned "
     "int const*, unsigned int const*, long, int, int, int, unsigned int*)",
     "B1 histogram"),
    ("void (anonymous namespace)::histogram_group_kernel<true, false>("
     "unsigned int const*)", "B1 histogram"),
    ("void (anonymous namespace)::scan_kernel<true>(unsigned int const*, "
     "unsigned int*, unsigned long*, unsigned int*, long)", "B2 scan"),
    ("void (anonymous namespace)::scan_kernel<false>(unsigned int const*)",
     "B2 scan"),
    ("void (anonymous namespace)::rank_kernel<true>(unsigned int const*)",
     "B3 rank+scatter"),
    ("void (anonymous namespace)::rank_wide_kernel(unsigned int const*)",
     "B3 rank+scatter"),
    ("void (anonymous namespace)::scatter_wide_kernel<true>(unsigned int "
     "const*)", "B3 rank+scatter"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<long> >"
     "(at::native::ReduceOp<long>)", "elementwise/other"),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<int>(int*)",
     "sort (torch)"),
    ("void at::native::tensor_kernel_scan_innermost_dim<long>(long*)",
     "scans (cumsum, cummax)"),
    ("void at::native::index_elementwise_kernel<128, 4>(long, int)",
     "gathers, scatters"),
    ("void (anonymous namespace)::elementwise_kernel_with_index<int, "
     "at::native::arange_cuda_out>(int)", "elementwise/other"),
    ("Memcpy DtoD (Device -> Device)", "copies"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::BitwiseAndFunctor<long> >(int)", "elementwise/other"),
])
def test_profile_categories_name_the_kernels(kernel, category):
    assert matrix._category(kernel) == category
