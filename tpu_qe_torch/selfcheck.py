"""On-card self-check: every CUDA kernel and sort backend of the port, run
on the card and held against its C++ or numpy oracle.

    python -m tpu_qe_torch.selfcheck

The CPU tests reach only the kernels' plain twins; this runs the kernels
themselves. Ten checks: B1 against the C++ histogram, B3's rank against
B6's, B2 against numpy, B5 against numpy's sort, B4 against the C++ direct
encoder, the fused encode of triangles and of points against the C++
encoder, E2's GROUP BY counts and exact sums against numpy, E3's inner
join index and slots against numpy, the sort backends against the C++ LSD
sort, and the flagship pipeline against the C++ pipeline oracle. Prints
PASS or FAIL per check and SELFCHECK PASS or SELFCHECK FAIL; exits 1 if
any check fails or there is no CUDA card.
"""

from __future__ import annotations

import sys
import traceback

import numpy as np
import torch


def _check(name: str, fn) -> bool:
    # the boundary that keeps the remaining checks running: the failure is
    # reported with its traceback and turns the exit code to 1
    try:
        fn()
    except Exception as e:  # noqa: BLE001
        print(f"FAIL  {name}: {type(e).__name__}: {str(e)[:200]}")
        traceback.print_exc(file=sys.stderr)
        return False
    print(f"PASS  {name}")
    return True


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _planes(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(
        np.int32)).to(dev)


def main() -> int:
    from tpu_qe_torch import morton, native
    from tpu_qe_torch.bits import U64
    from tpu_qe_torch.config import resolve_device
    from tpu_qe_torch.kernels import morton as mk
    from tpu_qe_torch.kernels.bitonic import sort_chunks
    from tpu_qe_torch.kernels.histogram import (block_histogram,
                                                block_rank_and_histogram)
    from tpu_qe_torch.kernels.rank_mxu import block_rank_and_histogram_mxu
    from tpu_qe_torch.kernels.scan import exclusive_scan
    from tpu_qe_torch.ops.aggregate import group_aggregate_multi
    from tpu_qe_torch.ops.join import join_inner
    from tpu_qe_torch.pipeline import build_scene_index
    from tpu_qe_torch.sort import sort_u64_numpy
    from tpu_qe_torch.table import Table, column_from_numpy

    dev = resolve_device("cuda")   # raises without a CUDA card
    print(f"device: {torch.cuda.get_device_name(dev)}")
    rng = np.random.default_rng(7)
    ok = True

    def c_hist():
        keys = rng.integers(0, 1 << 64, 4 * 4096, dtype=np.uint64)
        k = U64.from_numpy(keys, dev)
        got = block_histogram(k.lo, k.hi, 16, 8, block=4096)
        want = native.digit_major_histogram(keys, 2, 8, 4096)
        np.testing.assert_array_equal(_u32(got), want)
    ok &= _check("block_histogram vs C++ oracle", c_hist)

    def c_rank():
        keys = rng.integers(0, 1 << 64, 2 * 2048, dtype=np.uint64)
        k = U64.from_numpy(keys, dev)
        r1, h1 = block_rank_and_histogram(k.lo, k.hi, 40, 8, block=2048)
        r2, h2 = block_rank_and_histogram_mxu(k.lo, k.hi, 40, block=2048)
        np.testing.assert_array_equal(_u32(r1), _u32(r2))
        np.testing.assert_array_equal(_u32(h1), _u32(h2))
    ok &= _check("rank B3 == rank B6 (tensor cores)", c_rank)

    def c_scan():
        x = rng.integers(0, 1 << 16, 1 << 14, dtype=np.uint32)
        got = exclusive_scan(_planes(x, dev))
        np.testing.assert_array_equal(_u32(got),
                                      np.cumsum(x, dtype=np.uint32) - x)
    ok &= _check("exclusive_scan vs numpy", c_scan)

    def c_bitonic():
        lo = rng.integers(0, 1 << 32, (4, 8192), dtype=np.uint32)
        hi = rng.integers(0, 1 << 32, (4, 8192), dtype=np.uint32)
        slo, shi = sort_chunks(_planes(lo, dev), _planes(hi, dev), rows=64)
        got = (_u32(slo).astype(np.uint64)
               | (_u32(shi).astype(np.uint64) << np.uint64(32)))
        ref = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
        np.testing.assert_array_equal(np.sort(ref, axis=1), got)
    ok &= _check("bitonic chunk sort vs numpy sort", c_bitonic)

    def c_morton():
        _, _, smin, smax = native.scene_generate(200, 600, 7)
        params = morton.MortonParams.for_scene(smin, smax, dev)
        q = rng.integers(0, 1 << 20, (2048, 3), dtype=np.uint32)
        j = rng.integers(0, 1 << 12, 2048, dtype=np.uint32)
        got = mk.encode_quantized_lut(_planes(q, dev), _planes(j, dev),
                                      params.lut_lo, params.lut_hi)
        want = native.morton_encode_direct(
            np.concatenate([q, j[:, None]], axis=1))
        np.testing.assert_array_equal(got.to_numpy(), want)
    ok &= _check("morton LUT kernel vs C++ direct encode", c_morton)

    def c_fused():
        verts, tris, smin, smax = native.scene_generate(2000, 6001, 5)
        gen = native.MortonGen(smin, smax)
        params = morton.MortonParams.from_native(gen, dev)
        got = mk.encode_triangles(torch.from_numpy(verts).to(dev),
                                  torch.from_numpy(tris.astype(np.int64)).to(
                                      dev), params)
        np.testing.assert_array_equal(got.to_numpy(), gen.encode(verts, tris))
        # points are degenerate triangles to the C++ encoder
        cols = [torch.from_numpy(verts[:, a].copy()).to(dev)
                for a in range(3)]
        got = mk.encode_points(*cols, None, params)
        same = np.repeat(np.arange(2000, dtype=np.uint32)[:, None], 3, 1)
        np.testing.assert_array_equal(got.to_numpy(), gen.encode(verts, same))
    ok &= _check("fused morton encode (triangles, points) vs C++ encoder",
                 c_fused)

    def c_groupsum():
        n = 3 * 4096 + 5
        keys = rng.integers(0, 50, n).astype(np.uint64) << np.uint64(31)
        u = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        i = rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
        valid = rng.random(n) < 0.8
        res = group_aggregate_multi(
            U64.from_numpy(keys, dev), {"u": column_from_numpy(u, dev),
                                        "i": column_from_numpy(i, dev)},
            {"u": ("count", "sum"), "i": ("sum",)},
            valid=torch.from_numpy(valid).to(dev))
        uk, inv = np.unique(keys[valid], return_inverse=True)
        g = len(uk)
        usum, isum = np.zeros(g, np.uint64), np.zeros(g, np.int64)
        np.add.at(usum, inv, u[valid].astype(np.uint64))
        np.add.at(isum, inv, i[valid].astype(np.int64))
        assert int(res.num_groups) == g
        np.testing.assert_array_equal(res.key.to_numpy()[:g], uk)
        np.testing.assert_array_equal(res.aggs["u_count"][:g].cpu().numpy(),
                                      np.bincount(inv, minlength=g))
        np.testing.assert_array_equal(res.aggs["u_sum"].to_numpy()[:g], usum)
        np.testing.assert_array_equal(
            res.aggs["i_sum"].to_numpy()[:g].astype(np.int64), isum)
    ok &= _check("GROUP BY counts and exact sums (E2) vs numpy", c_groupsum)

    def c_join():
        # duplicate right keys past the shared-memory fence, unmatched left
        # keys: every slot in left order, then sorted right order
        rkeys = rng.integers(0, 5000, 20_000).astype(np.uint64) << 20
        lkeys = rng.integers(0, 6000, 30_001).astype(np.uint64) << 20
        order = np.argsort(rkeys, kind="stable")
        lo = np.searchsorted(rkeys[order], lkeys, "left")
        c = np.searchsorted(rkeys[order], lkeys, "right") - lo
        total = int(c.sum())
        li = np.repeat(np.arange(len(lkeys)), c)
        ri = lo[li] + np.arange(total) - (np.cumsum(c) - c)[li]
        res = join_inner(
            Table.from_numpy({"key": lkeys, "a": np.arange(
                len(lkeys), dtype=np.uint32)}, dev),
            Table.from_numpy({"key": rkeys, "b": np.arange(
                len(rkeys), dtype=np.uint32)}, dev), out_budget=total)
        assert int(res.num_out) == total and int(res.overflow) == 0
        np.testing.assert_array_equal(_u32(res.table["a"]), li)
        np.testing.assert_array_equal(_u32(res.table["b"]), order[ri])
    ok &= _check("inner join index and slots (E3) vs numpy", c_join)

    def c_backends():
        keys = rng.integers(0, 1 << 64, 200_000, dtype=np.uint64)
        pay = np.arange(len(keys), dtype=np.uint32)
        want_k, want_p = native.lsd_sort(keys, pay)
        for backend in ("radix", "torch", "torch_tiebreak"):
            got_k, got_p = sort_u64_numpy(keys, pay, device=dev,
                                          backend=backend)
            np.testing.assert_array_equal(got_k, want_k, err_msg=backend)
            np.testing.assert_array_equal(got_p, want_p, err_msg=backend)
    ok &= _check("sort backends vs C++ oracle (200K keys)", c_backends)

    def c_pipeline():
        idx = build_scene_index(device=dev)
        codes, order = native.pipeline_oracle(1000, 3000, 7)
        np.testing.assert_array_equal(idx.code.to_numpy(), codes)
        np.testing.assert_array_equal(_u32(idx.order), order)
    ok &= _check("flagship pipeline vs C++ oracle", c_pipeline)

    torch.cuda.synchronize(dev)
    print("SELFCHECK", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
