"""The CUDA kernels of tpu_qe_torch on the card, against their plain
PyTorch twins on the same card and the C++ oracles (tolerance: exact
equality). Every test here needs a CUDA card and skips without one.

On a machine with the card (which need not have JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

This file imports nothing of JAX or tpu_qe.
"""

import importlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_qe_torch import kernels, morton, native  # noqa: E402
from tpu_qe_torch.__main__ import main  # noqa: E402
from tpu_qe_torch.bits import U64  # noqa: E402
from tpu_qe_torch.kernels import bitonic as bk  # noqa: E402
from tpu_qe_torch.kernels import histogram as hk  # noqa: E402
from tpu_qe_torch.kernels import morton as mk  # noqa: E402
from tpu_qe_torch.kernels import rank_mxu as rk  # noqa: E402
from tpu_qe_torch.kernels import scan as sk  # noqa: E402
from tpu_qe_torch.sort import sort_u64, sort_u64_numpy  # noqa: E402
from tpu_qe_torch.ops import aggregate as tagg  # noqa: E402
from tpu_qe_torch.ops import join as tjoin  # noqa: E402
from tpu_qe_torch.sort import planes as sp  # noqa: E402
from tpu_qe_torch.table import Table  # noqa: E402

pytestmark = pytest.mark.cuda

DIGITS = [(0, 8), (24, 8), (32, 8), (56, 8), (30, 6), (60, 4), (7, 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _keys(n, seed):
    return np.random.default_rng(seed).integers(0, 1 << 64, n,
                                                dtype=np.uint64)


def _u32_tensor(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(
        np.int32)).to(dev)


def _params(dev):
    _, _, smin, smax = native.scene_generate(100, 300, 7)
    return morton.MortonParams.for_scene(smin, smax, dev)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("n", [1, 255, 4096, 4097, 100_003])
@pytest.mark.parametrize("shift,bits", DIGITS)
def test_histogram_rank_scan_scatter_match_twins(cuda, shift, bits, n):
    keys = _keys(n, n + shift)
    k = U64.from_numpy(keys, cuda)
    hist = hk.block_histogram(k.lo, k.hi, shift, bits)
    _same(hist, hk.block_histogram_plain(k.lo, k.hi, shift, bits))
    if shift % bits == 0:
        np.testing.assert_array_equal(
            hist.cpu().numpy().view(np.uint32),
            native.digit_major_histogram(keys, shift // bits, bits, 4096))
    ranks, hist2 = hk.block_rank_and_histogram(k.lo, k.hi, shift, bits)
    pr, ph = hk.block_rank_and_histogram_plain(k.lo, k.hi, shift, bits)
    _same(ranks, pr)
    _same(hist2, ph)
    base = sk.exclusive_scan(hist.reshape(-1))
    _same(base, sk.exclusive_scan_plain(hist.reshape(-1)))
    pay = torch.arange(n, dtype=torch.int32, device=cuda)
    got = hk.rank_and_scatter(k.lo, k.hi, [pay, pay * 3], base, shift, bits)
    want = hk.rank_and_scatter_plain(k.lo, k.hi, [pay, pay * 3], base, shift,
                                     bits)
    _same(got[0], want[0])
    _same(got[1], want[1])
    for g, w in zip(got[2], want[2]):
        _same(g, w)


@pytest.mark.parametrize("n", [0, 1, 1023, 4096, 4097, 1 << 20, 12_345_679])
def test_exclusive_scan_wraps(cuda, n):
    x = np.random.default_rng(n).integers(1 << 31, 1 << 32, n,
                                          dtype=np.uint64)
    got = sk.exclusive_scan(torch.from_numpy(
        x.astype(np.uint32).view(np.int32)).to(cuda))
    want = ((np.cumsum(x) - x) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32), want)


B2_TILE = 8192   # words per tile of B2's single-pass kernel (csrc/scan.cu)


def _scan_input(kind, n, dev):
    if kind == "all_ones":       # wraps in every tile's aggregate
        return torch.full((n,), -1, dtype=torch.int32, device=dev)
    if kind == "large_then_zeros":
        x = torch.zeros(n, dtype=torch.int32, device=dev)
        x[:1] = -16              # 0xFFFFFFF0
        return x
    g = torch.Generator(device=dev).manual_seed(n)
    return torch.randint(-(1 << 31), (1 << 31) - 1, (n,), generator=g,
                         device=dev, dtype=torch.int64).to(torch.int32)


@pytest.mark.parametrize("n", [0, 1, 3, B2_TILE - 1, B2_TILE, B2_TILE + 1,
                               3 * B2_TILE + 3, 1 << 17, 1 << 24])
@pytest.mark.parametrize("kind", ["random", "all_ones", "large_then_zeros"])
def test_exclusive_scan_hard_shapes(cuda, kind, n):
    x = _scan_input(kind, n + 1, cuda)
    for t in (x[:n], x[1:]):     # 16-byte aligned, and 4 bytes off
        _same(sk.exclusive_scan(t), sk.exclusive_scan_plain(t))
    small = x[:min(n, 100_000)]
    wide = small.cpu().numpy().view(np.uint32).astype(np.uint64)
    np.testing.assert_array_equal(
        sk.exclusive_scan(small).cpu().numpy().view(np.uint32),
        (np.cumsum(wide) - wide) & np.uint64(0xFFFFFFFF))


def test_exclusive_scan_of_the_largest_table(cuda):
    x = _scan_input("random", 1 << 28, cuda)     # a 16-bit pass at 2^24 keys
    _same(sk.exclusive_scan(x), sk.exclusive_scan_plain(x))


def test_exclusive_scans_back_to_back_with_fresh_scratch(cuda):
    # the allocator hands the same scratch out again with the last scan's
    # status words in it; two lengths in turns, so stale words differ in kind
    xs = [_scan_input("random", n, cuda) for n in ((1 << 20) + 5, 300_000)]
    wants = [sk.exclusive_scan_plain(x) for x in xs]
    bad = torch.zeros((), dtype=torch.int64, device=cuda)
    kernels.reset_launches()
    for i in range(1000):
        bad += (sk.exclusive_scan(xs[i % 2]) != wants[i % 2]).sum()
    assert int(bad) == 0
    assert kernels.LAUNCHES["exclusive_scan"] == 1000


def test_exclusive_scan_beside_a_busy_stream(cuda):
    side = torch.cuda.Stream(cuda)
    a = torch.randn(8192, 8192, device=cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        for _ in range(20):
            a @ a
    x = _scan_input("random", 1 << 24, cuda)
    for _ in range(10):
        got = sk.exclusive_scan(x)
    _same(got, sk.exclusive_scan_plain(x))
    torch.cuda.synchronize()


def test_each_wrapper_counts_its_launches(cuda):
    k = U64.from_numpy(_keys(5000, 1), cuda)
    kernels.reset_launches()
    hist = hk.block_histogram(k.lo, k.hi, 0, 8)
    base = sk.exclusive_scan(hist.reshape(-1))
    hk.block_rank_and_histogram(k.lo, k.hi, 0, 8)
    hk.rank_and_scatter(k.lo, k.hi, [], base, 0, 8)
    hk.block_histogram_plain(k.lo, k.hi, 0, 8)
    params = _params(cuda)
    q = _u32_tensor(np.zeros((10, 3), np.uint32), cuda)
    mk.encode_quantized_lut(q, q[:, 0].contiguous(), params.lut_lo,
                            params.lut_hi)
    bk.sort_chunks(k.lo[:1024].reshape(1, 1024), k.hi[:1024].reshape(1, 1024),
                   rows=8)
    rk.block_rank_and_histogram_mxu(k.lo, k.hi, 0)
    assert kernels.LAUNCHES == {"block_histogram": 1, "exclusive_scan": 1,
                                "block_rank_and_histogram": 1,
                                "rank_and_scatter": 1,
                                "encode_quantized_lut": 1, "sort_chunks": 1,
                                "block_rank_and_histogram_mxu": 1}


def test_kernel_limits_raise(cuda):
    k = U64.from_numpy(_keys(100, 2), cuda)
    with pytest.raises(ValueError):
        hk.block_histogram(k.lo, k.hi, 0, 17)  # digits take 1..16 bits
    with pytest.raises(ValueError):            # u16 counters of wide digits
        hk.block_histogram(k.lo, k.hi, 0, 9, block=1 << 16)
    hist = hk.block_histogram(k.lo, k.hi, 0, 8)
    base = sk.exclusive_scan(hist.reshape(-1))
    with pytest.raises(ValueError):
        hk.rank_and_scatter(k.lo, k.hi, [k.lo] * 9, base, 0, 8)


B3_TILE = 4096   # keys per tile of B3's 1..8-bit kernel (csrc/radix.cu)


def _b3_keys(n, kind, shift, bits, seed):
    """(keys, lo is hi?) for B3's hard cases: random, every key on one
    digit, heavy ties (two digits), and a lone plane passed as both words."""
    keys = _keys(n, seed)
    mask = np.uint64(((1 << bits) - 1) << shift)
    if kind == "skewed":
        keys = (keys & ~mask) | ((np.uint64(0x5A5A) << np.uint64(shift)) & mask)
    elif kind == "ties":
        keys = keys & ~mask | (keys >> np.uint64(63) << np.uint64(shift))
    elif kind == "lone":
        keys = (keys & np.uint64(0xFFFFFFFF)) * np.uint64(0x100000001)
    return keys, kind == "lone"


def _check_b3(cuda, keys, lone, shift, bits, block, n_pay):
    """B3's rank mode and scatter on the card against their plain twins and
    the C++ counting oracle."""
    n = len(keys)
    k = U64.from_numpy(keys, cuda)
    lo, hi = k.lo, k.lo if lone else k.hi
    radix, nb = 1 << bits, -(-n // block)
    d = ((keys >> np.uint64(shift)) & np.uint64(radix - 1)).astype(np.int64)
    blk = np.arange(n, dtype=np.int64) // block
    ranks, hist = hk.block_rank_and_histogram(lo, hi, shift, bits, block)
    pr, ph = hk.block_rank_and_histogram_plain(lo, hi, shift, bits, block)
    _same(ranks, pr)
    _same(hist, ph)
    np.testing.assert_array_equal(
        ranks.cpu().numpy().view(np.uint32),
        native.block_rank((blk * radix + d).astype(np.uint32), nb * radix))
    _same(hist, hk.block_histogram(lo, hi, shift, bits, block))
    base = sk.exclusive_scan(hist.reshape(-1))
    pays = [torch.arange(n, dtype=torch.int32, device=cuda) * (2 * i + 1) + i
            for i in range(n_pay)]
    got = hk.rank_and_scatter(lo, hi, pays, base, shift, bits, block)
    want = hk.rank_and_scatter_plain(lo, hi, pays, base, shift, bits, block)
    _same(got[0], want[0])
    _same(got[1], want[1])
    assert len(got[2]) == n_pay
    for g, w in zip(got[2], want[2]):
        _same(g, w)
    # one pass is the stable sort by the digit
    order = np.argsort(d, kind="stable")
    np.testing.assert_array_equal(
        got[0].cpu().numpy().view(np.uint32),
        (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)[order])
    if n_pay:
        np.testing.assert_array_equal(got[2][0].cpu().numpy(), order)


@pytest.mark.parametrize("n_pay", [0, 3, 8])
@pytest.mark.parametrize("block", [1000, 4096, 5000, 65536])
@pytest.mark.parametrize("kind,shift,bits", [
    ("random", 0, 8), ("random", 28, 8), ("random", 31, 2), ("random", 7, 1),
    ("skewed", 24, 8), ("ties", 40, 8), ("lone", 0, 1), ("lone", 24, 8)])
def test_b3_blocks_payloads_and_digits(cuda, kind, shift, bits, block, n_pay):
    # 2 1/2 blocks of 65536, 41 blocks of 4096 and a ragged tail
    n = 168_000 + 777
    keys, lone = _b3_keys(n, kind, shift, bits, n + shift + block)
    _check_b3(cuda, keys, lone, shift, bits, block, n_pay)


@pytest.mark.parametrize("n", [1, 31, 33, B3_TILE - 1, B3_TILE, B3_TILE + 1,
                               2 * B3_TILE + 1, (1 << 22) + 777])
@pytest.mark.parametrize("block", [1000, 4096, 5000, 65536])
def test_b3_ragged_sizes(cuda, n, block):
    for kind, shift, bits in (("random", 28, 8), ("skewed", 0, 8)):
        keys, lone = _b3_keys(n, kind, shift, bits, n + block)
        _check_b3(cuda, keys, lone, shift, bits, block, 1)


@pytest.mark.parametrize("bpp,key_bits", [(8, 64), (6, 64), (8, 40), (4, 16)])
@pytest.mark.parametrize("n", [1, 3000, 1_000_003])
def test_radix_sort_matches_torch_sort_and_numpy(cuda, bpp, key_bits, n):
    keys = _keys(n, 7 * n + bpp)
    payload = np.arange(n, dtype=np.uint32)
    rk, rp = sort_u64_numpy(keys, payload, device=cuda, bits_per_pass=bpp,
                            key_bits=key_bits)
    tk, tp = sort_u64_numpy(keys, payload, device=cuda, backend="torch",
                            key_bits=key_bits)
    mask = np.uint64((1 << key_bits) - 1) if key_bits < 64 else ~np.uint64(0)
    order = np.argsort(keys & mask, kind="stable")
    np.testing.assert_array_equal(rk, keys[order])
    np.testing.assert_array_equal(rp, order)
    np.testing.assert_array_equal(tk, rk)
    np.testing.assert_array_equal(tp, rp)


def test_sort_leaves_inputs_and_runs_on_the_keys_device(cuda):
    keys = _keys(10_000, 3)
    k = U64.from_numpy(keys, cuda)
    sk_, (sp,) = sort_u64(k, torch.arange(10_000, dtype=torch.int32,
                                          device=cuda))
    assert sk_.lo.device == k.lo.device == sp.device
    np.testing.assert_array_equal(k.to_numpy(), keys)


@pytest.mark.parametrize("extra", [[], ["--bits-per-pass", "6",
                                        "--num-passes", "11"]])
def test_verify_on_the_card(cuda, extra, capsys):
    kernels.reset_launches()
    assert main(["verify", "--triangles", "300000", "--vertices", "100000",
                 "--device", "cuda"] + extra) == 0
    assert capsys.readouterr().out.strip().endswith("VERIFY PASS")
    passes = 11 if extra else 8
    assert kernels.LAUNCHES["rank_and_scatter"] == passes
    assert kernels.LAUNCHES["block_histogram"] == passes
    assert kernels.LAUNCHES["exclusive_scan"] == passes


@pytest.mark.parametrize("quirk", [False, True])
@pytest.mark.parametrize("n", [0, 1, 1023, 100_003])
def test_morton_lut_kernel_matches_twin_and_native(cuda, n, quirk):
    rng = np.random.default_rng(n)
    q = rng.integers(0, 1 << 20, (n, 3), dtype=np.uint32)
    j = rng.integers(0, 1 << 12, n, dtype=np.uint32)
    params = _params(cuda)
    qt, jt = _u32_tensor(q, cuda), _u32_tensor(j, cuda)
    got = mk.encode_quantized_lut(qt, jt, params.lut_lo, params.lut_hi, quirk)
    want = mk.encode_quantized_lut_plain(qt, jt, params.lut_lo,
                                         params.lut_hi, quirk)
    _same(got.lo, want.lo)
    _same(got.hi, want.hi)
    via_morton = morton.encode_quantized_lut(qt, jt, params, quirk)
    _same(via_morton.lo, got.lo)
    if not quirk:
        np.testing.assert_array_equal(got.to_numpy(), native.morton_encode_direct(
            np.concatenate([q, j[:, None]], axis=1)))


def test_morton_encode_lut_on_the_card_matches_native(cuda):
    verts, tris, smin, smax = native.scene_generate(5000, 20_000, 3)
    gen = native.MortonGen(smin, smax)
    params = morton.MortonParams.from_native(gen, cuda)
    v = torch.from_numpy(verts).to(cuda)
    t = torch.from_numpy(tris.astype(np.int32)).to(cuda)
    for quirk in (False, True):
        kernels.reset_launches()
        got = morton.encode(v, t, params, use_lut=not quirk, quirk_lut=quirk)
        assert kernels.LAUNCHES["encode_quantized_lut"] == 1
        np.testing.assert_array_equal(got.to_numpy(),
                                      gen.encode(verts, tris, quirk=quirk))


def _chunks(nb, width, seed, ties, n_pay):
    rng = np.random.default_rng(seed)
    top = 4 if ties else 1 << 32
    planes = [rng.integers(0, top, (nb, width), dtype=np.uint64),
              rng.integers(0, 2 if ties else top, (nb, width),
                           dtype=np.uint64)]
    planes += [rng.integers(0, 1 << 32, (nb, width), dtype=np.uint64)
               for _ in range(n_pay)]
    return planes


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n_pay", [0, 1, 3, 8])
@pytest.mark.parametrize("rows,nb", [(1, 3), (8, 5), (64, 2)])
def test_bitonic_kernel_matches_twin(cuda, rows, nb, n_pay, ties):
    planes = [_u32_tensor(a, cuda)
              for a in _chunks(nb, rows * 128, rows + n_pay, ties, n_pay)]
    got = bk.sort_chunks(*planes, rows=rows)
    want = bk.sort_chunks_plain(*planes, rows=rows)
    assert len(got) == 2 + n_pay
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("n_pay", [1, 8])
def test_bitonic_kernel_beyond_shared_memory(cuda, n_pay):
    tile = bk.shared_tile(1 << 30, 2 + n_pay, cuda)
    width = 4 * tile
    planes = [_u32_tensor(a, cuda)
              for a in _chunks(2, width, n_pay, True, n_pay)]
    kernels.reset_launches()
    got = bk.sort_chunks(*planes, rows=width // 128)
    # tile launch; k = 2 tile: 1 stage + tile; k = 4 tile: 2 stages + tile
    assert kernels.LAUNCHES["sort_chunks"] == 6
    want = bk.sort_chunks_plain(*planes, rows=width // 128)
    for g, w in zip(got, want):
        _same(g, w)
    key = got[0].cpu().numpy().view(np.uint32).astype(np.uint64) | (
        got[1].cpu().numpy().view(np.uint32).astype(np.uint64) << 32)
    assert (np.diff(key.astype(np.float64), axis=1) >= 0).all()


def test_bitonic_kernel_rejects_bad_arguments(cuda):
    lo = torch.zeros((2, 1024), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        bk.sort_chunks(lo, lo, rows=4)                  # width != rows * 128
    odd = torch.zeros((2, 384), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        bk.sort_chunks(odd, odd, rows=3)                # not a power of two
    with pytest.raises(ValueError):
        bk.sort_chunks(lo, lo, *[lo] * 9, rows=8)       # 9 payloads
    with pytest.raises(ValueError):
        bk.sort_chunks(lo, lo.to(torch.int64), rows=8)


@pytest.mark.parametrize("block", [1000, 1024, 2048, 4096, 8192, 65535])
@pytest.mark.parametrize("n", [0, 1, 1023, 100_003])
def test_rank_mxu_kernel_matches_twin_and_b3(cuda, n, block):
    rng = np.random.default_rng(n + block)
    blk = np.arange(n, dtype=np.int64) // block
    for keys in (rng.integers(0, 1 << 64, n, dtype=np.uint64),
                 rng.integers(0, 2, n, dtype=np.uint64),
                 np.full(n, 0x5A, dtype=np.uint64)):
        k = U64.from_numpy(keys, cuda)
        for shift in (0, 28, 40, 56):
            r, h = rk.block_rank_and_histogram_mxu(k.lo, k.hi, shift, block)
            tr, th = rk.block_rank_and_histogram_mxu_plain(k.lo, k.hi, shift,
                                                           block)
            r3, h3 = hk.block_rank_and_histogram(k.lo, k.hi, shift, 8, block)
            for a, b in ((r, tr), (h, th), (r, r3), (h, h3)):
                _same(a, b)
            d = ((keys >> np.uint64(shift)) & np.uint64(255)).astype(np.int64)
            want = native.block_rank((blk * 256 + d).astype(np.uint32),
                                     max(-(-n // block), 1) * 256)
            np.testing.assert_array_equal(
                r.cpu().numpy().view(np.uint32), want)


def test_rank_mxu_kernel_rejects_bad_arguments(cuda):
    k = U64.from_numpy(_keys(100, 5), cuda)
    with pytest.raises(ValueError):
        rk.block_rank_and_histogram_mxu(k.lo, k.hi, 57)   # past bit 63
    with pytest.raises(ValueError):
        rk.block_rank_and_histogram_mxu(k.lo, k.hi, 0, block=0)
    with pytest.raises(ValueError):
        rk.block_rank_and_histogram_mxu(k.lo, k.hi[:50], 0)


def test_morton_lut_kernel_rejects_bad_arguments(cuda):
    params = _params(cuda)
    q = torch.zeros((10, 3), dtype=torch.int32, device=cuda)
    j = torch.zeros(10, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        mk.encode_quantized_lut(q[:, :2], j, params.lut_lo, params.lut_hi)
    with pytest.raises(ValueError):
        mk.encode_quantized_lut(q, j[:5], params.lut_lo, params.lut_hi)
    with pytest.raises(ValueError):
        mk.encode_quantized_lut(q, j, params.lut_lo[:8], params.lut_hi)
    with pytest.raises(ValueError):
        mk.encode_quantized_lut(q.cpu(), j, params.lut_lo, params.lut_hi)


@pytest.mark.parametrize("backend", ["torch_tiebreak"])
def test_tiebreak_backend_on_the_card(cuda, backend):
    keys = _keys(100_003, 9) & np.uint64(0xFF)       # heavy ties
    payload = np.arange(100_003, dtype=np.uint32)
    k, p = sort_u64_numpy(keys, payload, device=cuda, backend=backend)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(k, keys[order])
    np.testing.assert_array_equal(p, order)


def test_selfcheck_and_bench_kernels_on_the_card(cuda, capsys):
    from tpu_qe_torch import selfcheck
    assert selfcheck.main() == 0
    assert main(["bench-kernels", "--n", str(1 << 16)]) == 0
    out = capsys.readouterr().out
    assert "SELFCHECK PASS" in out
    for name in ("morton_lut_kernel", "morton_lut_plain",
                 "morton_direct_plain", "block_histogram_r256",
                 "block_rank_r256", "rank_and_scatter_r256",
                 "bitonic_chunk8192"):
        assert f'"kernel {name}"' in out


def test_b3_timing_script_on_the_card(cuda, capsys, tmp_path):
    from tpu_qe_torch.bench import radix_pass
    with pytest.raises(RuntimeError, match="not that tree's"):
        radix_pass.main(["--tree", str(tmp_path), "--n", "70777"])
    assert radix_pass.main(["--n", "70777"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(row["ms"]) >= {"block_rank", "scatter_p0", "scatter_p1",
                              "scatter_p3", "scatter_p1_lone",
                              "scatter_p1_lone_1bit", "scatter_p1_11bit",
                              "scatter_p1_16bit", "scatter_p1_11bit_b32768",
                              "scatter_p1_11bit_b65535", "block_rank_11bit",
                              "block_rank_16bit", "histogram_11bit",
                              "histogram_16bit", "sort_chunks_8192_p0",
                              "sort_chunks_8192_p1", "sort_chunks_8192_p3",
                              "sort_8bit_passes", "sort_6bit_passes",
                              "sort_11bit_passes"}
    scans = {k for k in row["ms"] if k.startswith("exclusive_scan_2p")}
    assert len(scans) == 5 and scans == set(row["queued_ms"]) == set(
        row["library_ms"]) == set(row["library_queued_ms"])
    for group in ("ms", "queued_ms", "library_ms", "library_queued_ms"):
        assert all(t > 0 for t in row[group].values())
    assert row["empty_launch_queued_ms"] > 0 and row["empty_launch_ms"] > 0
    assert row["torch_sort_chunks_8192_ms"] > 0
    assert row["headline"]["verified"] is True


WIDE_DIGITS = [(0, 11), (22, 11), (53, 11), (0, 16), (16, 16), (48, 16),
               (25, 9), (30, 13)]


@pytest.mark.parametrize("n", [1, 4097, 100_003])
@pytest.mark.parametrize("shift,bits", WIDE_DIGITS)
def test_wide_digit_kernels_match_twins_and_native(cuda, shift, bits, n):
    rng = np.random.default_rng(n + bits)
    rand = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    mask = np.uint64(((1 << bits) - 1) << shift)
    skew = (rand & ~mask) | (np.uint64(0x5A5A) << np.uint64(shift)) & mask
    block = 4096
    nb = -(-n // block)
    for keys in (rand, skew):
        k = U64.from_numpy(keys, cuda)
        hist = hk.block_histogram(k.lo, k.hi, shift, bits, block)
        _same(hist, hk.block_histogram_plain(k.lo, k.hi, shift, bits, block))
        if shift % bits == 0:
            np.testing.assert_array_equal(
                hist.cpu().numpy().view(np.uint32),
                native.digit_major_histogram(keys, shift // bits, bits,
                                             block))
        ranks, hist2 = hk.block_rank_and_histogram(k.lo, k.hi, shift, bits,
                                                   block)
        radix = 1 << bits
        d = ((keys >> np.uint64(shift)) & np.uint64(radix - 1)).astype(
            np.int64)
        blk = np.arange(n, dtype=np.int64) // block
        np.testing.assert_array_equal(
            ranks.cpu().numpy().view(np.uint32),
            native.block_rank((blk * radix + d).astype(np.uint32),
                              nb * radix))
        _same(hist2, hist)
        base = sk.exclusive_scan(hist.reshape(-1))
        pay = torch.arange(n, dtype=torch.int32, device=cuda)
        got = hk.rank_and_scatter(k.lo, k.hi, [pay, pay * 3], base, shift,
                                  bits, block)
        want = hk.rank_and_scatter_plain(k.lo, k.hi, [pay, pay * 3], base,
                                         shift, bits, block)
        for g, w in zip(got[:2] + tuple(got[2]), want[:2] + tuple(want[2])):
            _same(g, w)
        order = np.argsort(d, kind="stable")
        np.testing.assert_array_equal(got[2][0].cpu().numpy(), order)


def _wide_keys(n, kind, bits, seed):
    """(keys, shift): every key on one digit, each key of a run of 2^bits
    keys on its own digit, or random keys and a digit straddling bit 32."""
    keys = _keys(n, seed)
    mask = np.uint64((1 << bits) - 1)
    if kind == "one_digit":
        return (keys & ~mask) | (np.uint64(0x5A5A) & mask), 0
    if kind == "own_digits":
        return (keys & ~mask) | (
            (np.arange(n, dtype=np.uint64) * np.uint64(40503)) & mask), 0
    return keys, 32 - bits // 2


@pytest.mark.parametrize("n_pay", [0, 3])
@pytest.mark.parametrize("block", [4096, 5000, 32768, 65535])
@pytest.mark.parametrize("kind", ["one_digit", "own_digits", "straddling"])
@pytest.mark.parametrize("bits", [9, 11, 13, 16])
def test_wide_b3_blocks_payloads_and_digits(cuda, bits, kind, block, n_pay):
    n = 168_000 + 777
    keys, shift = _wide_keys(n, kind, bits, n + bits + block)
    _check_b3(cuda, keys, False, shift, bits, block, n_pay)


@pytest.mark.parametrize("n", [1, 31, 33, B3_TILE - 1, B3_TILE, B3_TILE + 1,
                               2 * B3_TILE + 1])
@pytest.mark.parametrize("block", [4096, 5000, 65535])
@pytest.mark.parametrize("bits", [9, 11, 13, 16])
def test_wide_b3_ragged_sizes(cuda, bits, block, n):
    for kind in ("straddling", "one_digit"):
        keys, shift = _wide_keys(n, kind, bits, n + block)
        _check_b3(cuda, keys, False, shift, bits, block, 1)


# ---- wide B1 (groups of eight key blocks, windows of 4096 digits, whole
# sectors) at the shapes it finds hard, against its twin and numpy

def _b1_wide_keys(n, kind, bits, seed):
    if kind != "two_digits":
        return _wide_keys(n, kind, bits, seed)
    keys = _keys(n, seed)
    mask = np.uint64((1 << bits) - 1)
    return (keys & ~mask) | np.where(keys >> np.uint64(63), mask,
                                     np.uint64(1)), 0


def _check_b1(cuda, keys, shift, bits, block):
    n, radix = len(keys), 1 << bits
    nb = -(-n // block)
    k = U64.from_numpy(keys, cuda)
    got = hk.block_histogram(k.lo, k.hi, shift, bits, block)
    _same(got, hk.block_histogram_plain(k.lo, k.hi, shift, bits, block))
    d = ((keys >> np.uint64(shift)) & np.uint64(radix - 1)).astype(np.int64)
    want = np.bincount(d * nb + np.arange(n, dtype=np.int64) // block,
                       minlength=radix * nb).reshape(radix, nb)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32), want)


@pytest.mark.parametrize("block", [1000, 4096, 5000, 32768, 65535])
@pytest.mark.parametrize("kind", ["one_digit", "own_digits", "straddling",
                                  "two_digits"])
@pytest.mark.parametrize("bits", [9, 11, 12, 13, 16])
def test_wide_b1_blocks_and_digits(cuda, bits, kind, block):
    n = 168_000 + 777
    keys, shift = _b1_wide_keys(n, kind, bits, n + bits + block)
    _check_b1(cuda, keys, shift, bits, block)


@pytest.mark.parametrize("n", [1, 4095, 4097, 65535, (1 << 22) + 777])
@pytest.mark.parametrize("bits", [9, 11, 13, 16])
def test_wide_b1_ragged_sizes(cuda, bits, n):
    for block in (1000, 4096, 65535):
        if n > 1 << 20 and block == 1000 and bits == 16:
            continue        # a table of 1.1 GB: the time, not the shape
        keys, shift = _b1_wide_keys(n, "straddling", bits, n + bits)
        _check_b1(cuda, keys, shift, bits, block)


@pytest.mark.parametrize("bits", [9, 13, 16])
def test_wide_b1_counts_a_whole_block_on_one_digit(cuda, bits):
    keys, shift = _b1_wide_keys(3 * 65535 + 10, "one_digit", bits, bits)
    _check_b1(cuda, keys, shift, bits, 65535)
    k = U64.from_numpy(keys, cuda)
    hist = hk.block_histogram(k.lo, k.hi, shift, bits, 65535)
    assert hist[0x5A5A & ((1 << bits) - 1)].tolist() == [65535] * 3 + [10]


@pytest.mark.parametrize("bits", [11, 16])
def test_wide_b1_back_to_back_into_recycled_memory(cuda, bits):
    # the allocator hands the last call's table out again: stale counts
    # must not survive in it, whatever the kernel does not write
    bad = torch.zeros((), dtype=torch.int64, device=cuda)
    cases = []
    for n, kind in ((100_003, "two_digits"), (70_777, "straddling")):
        keys, shift = _b1_wide_keys(n, kind, bits, n)
        k = U64.from_numpy(keys, cuda)
        cases.append((k, shift, hk.block_histogram_plain(k.lo, k.hi, shift,
                                                         bits, 4096)))
    for i in range(20):
        k, shift, want = cases[i % 2]
        bad += (hk.block_histogram(k.lo, k.hi, shift, bits, 4096)
                != want).sum()
    assert int(bad) == 0


def test_wide_b1_beside_a_busy_stream(cuda):
    side = torch.cuda.Stream(cuda)
    a = torch.randn(4096, 4096, device=cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        for _ in range(10):
            a @ a
    keys, shift = _b1_wide_keys(1 << 22, "straddling", 16, 5)
    _check_b1(cuda, keys, shift, 16, 4096)
    torch.cuda.synchronize()


# ---- B5 (elements in registers, 8192 a CUDA block) at the shapes it finds
# hard: chunks narrower than its tile, one chunk, an odd number of chunks,
# all keys equal, chunks in and against order, a view off the 16-byte
# alignment of its loads

@pytest.mark.parametrize("kind", ["all_equal", "sorted", "reversed", "ties"])
@pytest.mark.parametrize("n_pay", [0, 1, 8])
@pytest.mark.parametrize("rows,nb", [(1, 1), (2, 7), (4, 33), (8, 1),
                                     (64, 3), (256, 1)])
def test_bitonic_kernel_hard_shapes(cuda, rows, nb, n_pay, kind):
    width = rows * 128
    lo, hi, *pays = _chunks(nb, width, rows + nb, kind == "ties", n_pay)
    if kind == "all_equal":
        lo[:], hi[:] = 7, 3
    elif kind != "ties":
        key = np.sort(lo | (hi << np.uint64(32)), axis=1)
        if kind == "reversed":
            key = key[:, ::-1]
        lo, hi = key & np.uint64(0xFFFFFFFF), key >> np.uint64(32)
    planes = [_u32_tensor(a, cuda) for a in (lo, hi, *pays)]
    keep = [p.clone() for p in planes]
    got = bk.sort_chunks(*planes, rows=rows)
    want = bk.sort_chunks_plain(*planes, rows=rows)
    for g, w in zip(got, want):
        _same(g, w)
    for p, c in zip(planes, keep):
        _same(p, c)                     # inputs are not modified


def test_bitonic_kernel_takes_planes_off_alignment(cuda):
    flat = [_u32_tensor(a.reshape(-1), cuda)
            for a in _chunks(1, 3 * 1024 + 1, 5, True, 2)]
    planes = [f[1:].reshape(3, 1024) for f in flat]
    assert planes[0].data_ptr() % 16 == 4 and planes[0].is_contiguous()
    got = bk.sort_chunks(*planes, rows=8)
    for g, w in zip(got, bk.sort_chunks_plain(*planes, rows=8)):
        _same(g, w)


def test_verify_with_11_bit_digits_on_the_card(cuda, capsys):
    kernels.reset_launches()
    assert main(["verify", "--triangles", "300000", "--vertices", "100000",
                 "--bits-per-pass", "11", "--num-passes", "6",
                 "--device", "cuda"]) == 0
    assert capsys.readouterr().out.strip().endswith("VERIFY PASS")
    for name in ("block_histogram", "exclusive_scan", "rank_and_scatter"):
        assert kernels.LAUNCHES[name] == 6


@pytest.mark.parametrize("key_bits", [[32], [1, 32, 32], [32, 32, 2],
                                      [2, 32, 32, 32], [7, 32, 1, 32, 16],
                                      [32] * 6])
def test_sort_planes_radix_matches_torch_backend(cuda, key_bits):
    rng = np.random.default_rng(len(key_bits))
    n = 300_007
    planes = [_u32_tensor(rng.integers(0, 1 << b, n, dtype=np.uint64)
                          .astype(np.uint32), cuda) for b in key_bits]
    planes[0] = planes[0] & 0x3                   # ties in the top key
    planes.append(torch.arange(n, dtype=torch.int32, device=cuda))
    kernels.reset_launches()
    got = sp.sort_planes(planes, len(key_bits), key_bits)
    passes = sp.num_passes(len(key_bits), key_bits)
    for name in ("block_histogram", "exclusive_scan", "rank_and_scatter"):
        assert kernels.LAUNCHES[name] == passes
    want = sp.sort_planes(planes, len(key_bits), key_bits, backend="torch")
    for g, w in zip(got, want):
        _same(g, w)


def _op_tables(dev, n=20_000, seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n // 8, n).astype(np.uint64) * np.uint64(
        0x9E3779B97F4A7C15)
    cols = {"key": keys,
            "u": rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
                np.uint32),
            "i": rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32),
            "f": rng.standard_normal(n).astype(np.float32)}
    right = {"key": np.unique(keys[: n // 2]),
             "r": np.arange(len(np.unique(keys[: n // 2])), dtype=np.uint32)}
    return Table.from_numpy(cols, dev), Table.from_numpy(right, dev)


def _flat(x):
    if isinstance(x, torch.Tensor):
        return [x.view(torch.int32) if x.dtype in (torch.uint32,
                                                   torch.float32) else x]
    if isinstance(x, Table):
        return [t for nm in x for t in _flat(x[nm])]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _flat(x[k])]
    if x is None:
        return []
    return [t for v in x for t in _flat(v)]


OPERATORS = {
    "group_aggregate": lambda t, r, b: t.group_by(
        "key", "u", ("count", "sum", "min", "max", "count_distinct"),
        backend=b),
    "group_aggregate_valid_mean": lambda t, r, b: tagg.group_aggregate(
        t["key"], t["f"], ("mean", "min"), valid=t["i"] > 0, backend=b),
    "group_by_multi": lambda t, r, b: t.group_by_multi(
        "key", {"u": ("count", "sum"), "i": ("sum", "max"), "f": ("min",)},
        valid=t["i"] > -5, max_groups=1000, backend=b),
    "distinct": lambda t, r, b: t.distinct(backend=b),
    "sort_by": lambda t, r, b: t.sort_by("key", backend=b),
    "order_by": lambda t, r, b: t.order_by([("f", "desc"), "i", "key"],
                                           backend=b),
    "top_k": lambda t, r, b: t.top_k(100, largest=True, backend=b),
    "join": lambda t, r, b: t.join(r, backend=b),
    "join_semi": lambda t, r, b: t.join_semi(r, backend=b),
    "join_inner": lambda t, r, b: t.join_inner(r, backend=b),
    "join_outer": lambda t, r, b: t.join_outer(r, how="full", backend=b),
    "join_stream": lambda t, r, b: tjoin.join_fk_scan(
        t.drop("key"), r.drop("key"), t["key"], r["key"],
        l_valid=t["i"] > 0, output="stream", backend=b),
    "join_inner_padded": lambda t, r, b: tjoin.join_inner_padded(
        t.drop("key"), r.drop("key"), t["key"], r["key"], t["i"] > 0,
        r["r"].view(torch.int32) % 3 > 0, 40_000, backend=b),
    "set_op": lambda t, r, b: t.set_op(r, "except", backend=b),
}


@pytest.mark.parametrize("op", sorted(OPERATORS))
def test_operator_radix_matches_torch_backend_without_torch_sort(
        cuda, op, monkeypatch):
    t, r = _op_tables(cuda)
    want = _flat(OPERATORS[op](t, r, "torch"))

    def no_sort(*a, **k):
        raise AssertionError("torch.sort called on the radix path")

    monkeypatch.setattr(torch, "sort", no_sort)
    kernels.reset_launches()
    got = _flat(OPERATORS[op](t, r, "radix"))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rank_and_scatter"] > 0
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)


def test_bench_matrix_on_the_card(cuda, capsys):
    assert main(["bench-matrix", "--scale", "0.001",
                 "--configs", "filter_agg,join,join_agg,orderby,"
                 "count_distinct,setop,pipeline"]) == 0
    out = capsys.readouterr().out
    assert out.count('"backend_parity": true') == 8


def test_bench_matrix_profile_on_the_card(cuda, tmp_path, capsys):
    assert main(["bench-matrix", "--scale", "0.001", "--configs",
                 "filter_agg", "--trace-dir", str(tmp_path)]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    prof = rows[0]["profile"]
    assert (tmp_path / "filter_agg-0.json").exists()
    assert 0 < prof["device_busy_ms"] <= prof["wall_ms"]
    assert 0 <= prof["idle_share"] < 1
    cats = prof["by_category_ms"]
    for cat in ("B1 histogram", "B2 scan", "B3 rank+scatter"):
        assert cats[cat] > 0
    assert "sort (torch)" not in cats


# ---------------------------------------------------------- quantile, window

WINDOW_SPEC = {
    "rn": "row_number", "rk": ("rank",), "dr": ("dense_rank",),
    "pr": ("percent_rank",), "nt": ("ntile", 5), "rs": ("running_sum", "v"),
    "rmin": ("running_min", "v"), "lag": ("lag", "v", 0, 2),
    "lead": ("lead", "v"), "fv": ("first_value", "v"),
    "lv": ("last_value", "v"), "ms": ("moving_sum", "v", 4, 3),
    "mmax": ("moving_max", "v", 5), "mavg": ("moving_avg", "v", None, 2),
    "mc": ("moving_count", 3, 1), "ts": ("total_sum", "v"),
    "tavg": ("total_avg", "v"), "pc": ("partition_count",),
    "ravg": ("running_avg", "v"), "ru": ("range_sum", "v", "unbounded"),
    "rb": ("range_sum", "v", 3), "rbmin": ("range_min", "v", 2),
    "rba": ("range_avg", "v", 4)}


def _window_inputs(dtype, odt, n=20000, seed=3):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 50, n).astype(np.uint64) * np.uint64(
        0x9E3779B97F4A7C15)
    o = rng.integers(-30, 30, n)
    o = {"uint32": (o + 30).astype(np.uint32), "int32": o.astype(np.int32),
         "float32": (o * 0.5).astype(np.float32)}[odt]
    if dtype == "float32":
        v = (rng.standard_normal(n) * 100).astype(np.float32)
    else:
        v = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
            np.uint32).view(dtype)
    return k, o, v


def _cols(res):
    out = {}
    for name, c in res.cols.items():
        if isinstance(c, U64):
            out[name] = c.to_numpy()
        else:
            out[name] = c.cpu().view(torch.int32).numpy()
    return out


@pytest.mark.parametrize("dtype,odt", [("uint32", "uint32"),
                                       ("int32", "int32"),
                                       ("float32", "float32"),
                                       ("uint32", "int32")])
@pytest.mark.parametrize("output", ["input", "sorted"])
def test_window_on_the_card_matches_the_cpu(cuda, dtype, odt, output):
    from tpu_qe_torch.table import column_from_numpy
    window = importlib.import_module("tpu_qe_torch.ops.window").window
    k, o, v = _window_inputs(dtype, odt)
    got = {}
    for dev, backend in ((cuda, "radix"), (cuda, "torch"),
                         ("cpu", "radix")):
        kernels.reset_launches()
        res = window(U64.from_numpy(k, dev), WINDOW_SPEC,
                     order=column_from_numpy(o, dev),
                     values={"v": column_from_numpy(v, dev)},
                     output=output, backend=backend)
        if dev != "cpu":
            torch.cuda.synchronize()
        if (dev, backend) == (cuda, "radix"):
            assert kernels.LAUNCHES["rank_and_scatter"] == 12
        got[(str(dev), backend)] = (_cols(res), None if res.pos is None
                                    else res.pos.cpu().numpy())
    base_cols, base_pos = got[("cpu", "radix")]
    for key, (cols, pos) in got.items():
        if pos is not None:
            np.testing.assert_array_equal(pos, base_pos)
        for name, c in cols.items():
            if name in ("pr", "mavg", "tavg", "ravg", "rba") or (
                    dtype == "float32" and name not in (
                        "rn", "rk", "dr", "nt", "mc", "pc", "lag", "lead",
                        "fv", "lv", "rmin", "mmax", "rbmin")):
                np.testing.assert_allclose(
                    c.view(np.float32), base_cols[name].view(np.float32),
                    rtol=1e-5, atol=1e-3, err_msg=f"{key} {name}")
            else:
                np.testing.assert_array_equal(c, base_cols[name],
                                              err_msg=f"{key} {name}")


@pytest.mark.parametrize("max_groups", [None, 64, 16])
@pytest.mark.parametrize("dtype", ["uint32", "int32", "float32"])
def test_group_quantile_on_the_card_matches_the_cpu(cuda, dtype,
                                                    max_groups):
    from tpu_qe_torch.table import column_from_numpy
    tq = importlib.import_module("tpu_qe_torch.ops.quantile")
    k, _, v = _window_inputs(dtype, "uint32", n=30000, seed=9)
    qs = [(1, 1), 0.99, 0.0, 1.0, (3, 5)]
    outs = []
    for dev in (cuda, "cpu"):
        kernels.reset_launches()
        key, val = U64.from_numpy(k, dev), column_from_numpy(v, dev)
        d = tq.group_quantile(key, val, qs, max_groups=max_groups)
        c = tq.group_quantile_cont(key, val, qs, max_groups=max_groups)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["block_histogram"] == 24
        ng = int(d.num_groups)
        m = ng if max_groups is None else min(ng, max_groups)
        outs.append((ng, d.key.to_numpy()[:m],
                     d.quantiles.cpu().view(torch.int32).numpy()[:, :m],
                     d.count.cpu().numpy()[:m],
                     c.lower.cpu().view(torch.int32).numpy()[:, :m],
                     c.upper.cpu().view(torch.int32).numpy()[:, :m],
                     c.frac.cpu().numpy()[:, :m],
                     c.value.cpu().numpy()[:, :m]))
    for g, w in zip(outs[0][:-1], outs[1][:-1]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(outs[0][-1], outs[1][-1], rtol=1e-5,
                               atol=1e-3)


def test_global_quantiles_on_the_card(cuda):
    tq = importlib.import_module("tpu_qe_torch.ops.quantile")
    x = _keys(5000, 4)
    got = tq.quantile(U64.from_numpy(x, cuda), [0.5, 0.99, (1, 0)])
    s = np.sort(x)
    want = [s[tq.disc_rank(num, sh, 5000)]
            for num, sh in tq.canon_qs([0.5, 0.99, (1, 0)])]
    np.testing.assert_array_equal(got.to_numpy(), want)


# ------------------------------------------------------------- big sort

@pytest.mark.parametrize("strategy", ["partition", "merge"])
@pytest.mark.parametrize("payload_cols", [1, 3])
def test_sort_big_on_the_card_matches_numpy(cuda, strategy, payload_cols):
    from tpu_qe_torch.hashing import keygen_hash_numpy
    from tpu_qe_torch.sort import bigsort, driver
    n = 1 << 20
    kernels.reset_launches()
    driver.RADIX_PASSES.clear()
    res, out = bigsort.sort_big(n, run_size=1 << 18, n_buckets=5,
                                collect=True, strategy=strategy,
                                payload_cols=payload_cols)
    assert res.all_ok, res
    assert kernels.LAUNCHES["rank_and_scatter"] == sum(
        driver.RADIX_PASSES.values()) > 0
    want = keygen_hash_numpy(np.arange(n, dtype=np.uint32))
    order = np.argsort(want, kind="stable")
    np.testing.assert_array_equal(out[0], want[order])
    np.testing.assert_array_equal(out[1], order.astype(np.uint32))
    for j, col in enumerate(out[2] if payload_cols > 1 else ()):
        np.testing.assert_array_equal(
            col, bigsort._value_col_numpy(order.astype(np.uint32), j))


def test_sort_big_incore_on_the_card(cuda):
    from tpu_qe_torch.sort import bigsort
    res = bigsort.sort_big_incore(1 << 22)
    assert res.all_ok and res.seconds > 0


def test_bench_big_cli_on_the_card(cuda, capsys, tmp_path):
    for extra in ([], ["--in-core"], ["--strategy", "merge",
                                      "--payload-cols", "2"]):
        assert main(["bench-big", "--n", str(1 << 22), "--run-size",
                     str(1 << 20), "--checkpoint-dir",
                     str(tmp_path / "ck")] + extra) == 0
        row = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                          if ln.startswith("{")][-1])
        assert row["verified"] and row["value"] > 0
        assert row["peak_mem_bytes"] > 0 and "H100" in row["device"]
        assert (row["sol_fraction"] is None) == ("--in-core" in extra)
    assert main(["bench-big", "--n", str(1 << 22), "--run-size",
                 str(1 << 20), "--trace-dir", str(tmp_path / "tr")]) == 0
    row = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("{")][-1])
    prof = row["profile"]
    assert (tmp_path / "tr" / "trace.json").exists()
    assert 0 < prof["device_busy_ms"] <= prof["wall_ms"]
    assert prof["by_category_ms"]["B3 rank+scatter"] > 0


def test_bench_matrix_quantile_window_on_the_card(cuda, capsys):
    assert main(["bench-matrix", "--scale", "0.001",
                 "--configs", "window,quantile"]) == 0
    out = capsys.readouterr().out
    assert out.count('"backend_parity": true') == 3


# ------------------------------------------------ out-of-core operators

def _launched_as_recorded(run):
    from tpu_qe_torch.sort import driver
    kernels.reset_launches()
    driver.RADIX_PASSES.clear()
    out = run()
    torch.cuda.synchronize()
    planned = sum(driver.RADIX_PASSES.values())
    for name in ("block_histogram", "exclusive_scan", "rank_and_scatter"):
        assert kernels.LAUNCHES[name] == planned > 0, name
    return out


@pytest.mark.parametrize("minmax", [False, True])
def test_aggregate_big_on_the_card_matches_numpy(cuda, minmax):
    from tpu_qe_torch.ops import bigagg
    n, g = 1 << 20, 1 << 10
    res, table = _launched_as_recorded(lambda: bigagg.aggregate_big(
        n, n_groups=g, run_size=1 << 18, minmax=minmax, collect=True))
    assert res.all_ok, res
    idx = np.arange(n, dtype=np.uint32)
    gid = bigagg.group_of_index_numpy(idx, g)
    cnt = np.bincount(gid, minlength=g)
    sums = np.zeros(g, np.uint64)
    np.add.at(sums, gid, idx.astype(np.uint64))
    keep = cnt > 0
    np.testing.assert_array_equal(table["key"], np.flatnonzero(keep))
    np.testing.assert_array_equal(table["count"], cnt[keep])
    np.testing.assert_array_equal(table["sum"], sums[keep])
    if minmax:
        omin = np.full(g, 0xFFFFFFFF, np.uint32)
        np.minimum.at(omin, gid, idx)
        np.testing.assert_array_equal(table["min"], omin[keep])


def test_aggregate_big_multi_on_the_card_matches_numpy(cuda):
    from tpu_qe_torch.ops import bigagg
    n, g = 1 << 20, 1 << 12
    res, table = _launched_as_recorded(lambda: bigagg.aggregate_big_multi(
        n, n_groups=g, run_size=1 << 18, value_cols=3, collect=True))
    assert res.all_ok
    idx = np.arange(n, dtype=np.uint32)
    gid = bigagg.group_of_index_numpy(idx, g)
    keep = np.bincount(gid, minlength=g) > 0
    for c in range(3):
        s = np.zeros(g, np.uint64)
        np.add.at(s, gid, (idx + c).astype(np.uint64))
        np.testing.assert_array_equal(table[f"sum{c}"], s[keep])


def _np_join_keys(n_l, n_r):
    from tpu_qe_torch.hashing import keygen_hash_numpy
    j = np.arange(n_l, dtype=np.uint32)
    hit = keygen_hash_numpy((j * np.uint32(2654435761)) % np.uint32(n_r))
    return np.where(j % 2 == 0, hit & ~np.uint64(1),
                    keygen_hash_numpy(j, 8) | np.uint64(1))


def test_join_big_on_the_card_matches_numpy(cuda):
    from tpu_qe_torch.hashing import murmur_fmix32_numpy
    from tpu_qe_torch.ops import bigjoin
    n_l, n_r = 1 << 20, 1 << 19
    res, out = _launched_as_recorded(lambda: bigjoin.join_big(
        n_l, n_r, n_buckets=5, collect=True))
    assert res.all_ok and res.matched == n_l // 2
    keys, lidx = out["key"], out["lidx"]
    assert (keys[1:] >= keys[:-1]).all()
    np.testing.assert_array_equal(np.sort(lidx), np.arange(n_l))
    np.testing.assert_array_equal(keys, _np_join_keys(n_l, n_r)[lidx])
    np.testing.assert_array_equal(out["matched"], lidx % 2 == 0)
    val = murmur_fmix32_numpy((keys & np.uint64(0xFFFFFFFF)).astype(
        np.uint32) ^ (keys >> np.uint64(32)).astype(np.uint32)
        ^ np.uint32(0xABCD1234))
    np.testing.assert_array_equal(out["value"],
                                  np.where(out["matched"], val, 0))


def test_join_aggregate_big_on_the_card_matches_numpy(cuda):
    from tpu_qe_torch.hashing import murmur_fmix32_numpy
    from tpu_qe_torch.ops import bigpipe
    n, g = 1 << 20, 1 << 10
    res, table = _launched_as_recorded(lambda: bigpipe.join_aggregate_big(
        n, n, n_groups=g, n_buckets=3, collect=True))
    assert res.all_ok
    keys = _np_join_keys(n, n)[::2]
    vals = murmur_fmix32_numpy((keys & np.uint64(0xFFFFFFFF)).astype(
        np.uint32) ^ (keys >> np.uint64(32)).astype(np.uint32)
        ^ np.uint32(0xABCD1234)).astype(np.uint64)
    gid = bigpipe.group_of_join_key_numpy(keys, g)
    cnt = np.bincount(gid, minlength=g)
    sums = np.zeros(g, np.uint64)
    np.add.at(sums, gid, vals)
    keep = cnt > 0
    np.testing.assert_array_equal(table["key"], np.flatnonzero(keep))
    np.testing.assert_array_equal(table["count"], cnt[keep])
    np.testing.assert_array_equal(table["sum"], sums[keep])


@pytest.mark.parametrize("how", ["left", "full"])
def test_join_big_outer_on_the_card_matches_numpy(cuda, how):
    from tpu_qe_torch.ops import bigouter
    n_l, n_r = 1 << 20, 1 << 19
    res, out = _launched_as_recorded(lambda: bigouter.join_big_outer(
        n_l, n_r, how=how, n_buckets=4, collect=True))
    assert res.all_ok and res.num_out == n_l
    keys, lidx, matched = out["key"], out["lidx"], out["matched"]
    np.testing.assert_array_equal(np.sort(lidx), np.arange(n_l))
    np.testing.assert_array_equal(keys,
                                  bigouter.lkeys_numpy(n_l, n_r)[lidx])
    np.testing.assert_array_equal(matched, lidx % 2 == 0)
    np.testing.assert_array_equal(out["value"], np.where(
        matched, bigouter.rval_numpy(keys), 0))
    if how == "full":
        np.testing.assert_array_equal(np.sort(out["ro_ridx"]),
                                      np.arange(1, n_r, 2))


@pytest.mark.parametrize("largest", [False, True])
def test_top_k_big_on_the_card_matches_numpy(cuda, largest):
    from tpu_qe_torch.hashing import keygen_hash_numpy
    from tpu_qe_torch.ops import bigtopk
    n, k = 1 << 20, 1000
    res, (keys, pay) = _launched_as_recorded(lambda: bigtopk.top_k_big(
        n, k, run_size=1 << 18, largest=largest, collect=True))
    assert res.all_ok
    allk = keygen_hash_numpy(np.arange(n, dtype=np.uint32))
    order = np.argsort(~allk if largest else allk, kind="stable")[:k]
    np.testing.assert_array_equal(keys, allk[order])
    np.testing.assert_array_equal(pay, order)


def test_count_distinct_big_on_the_card_matches_numpy(cuda):
    from tpu_qe_torch.ops import bigdistinct
    n, g, v = 1 << 20, 1000, 37
    res = _launched_as_recorded(lambda: bigdistinct.count_distinct_big(
        n, n_groups=g, n_values=v, run_size=1 << 18, collect=True))
    assert res.all_ok
    keys, vals = bigdistinct.rows_of_index_numpy(np.arange(n), g, v)
    pairs = np.unique((keys.astype(np.uint64) << np.uint64(32)) | vals)
    np.testing.assert_array_equal(res.table["key"], np.arange(g))
    np.testing.assert_array_equal(res.table["count"], np.bincount(keys))
    np.testing.assert_array_equal(res.table["count_distinct"], np.bincount(
        (pairs >> np.uint64(32)).astype(np.int64)))


@pytest.mark.parametrize("op", ["union", "intersect", "except"])
def test_set_op_big_on_the_card_matches_numpy(cuda, op):
    from tpu_qe_torch.ops import bigsetops
    args = (op, 1 << 20, 1 << 20)
    kw = dict(g_a=3000, g_b=5000, offset=1000, run_size=1 << 18)
    res = _launched_as_recorded(lambda: bigsetops.set_op_big(
        *args, collect=True, **kw))
    assert res.all_ok
    for c, w in zip(("key", "count_a", "count_b"),
                    bigsetops.expected_result_numpy(
                        op, 1 << 20, 3000, 1 << 20, 5000, 1000)):
        np.testing.assert_array_equal(res.table[c], w)


@pytest.mark.parametrize("argv", [
    ["bench-bigagg", "--n", str(1 << 20), "--run-size", str(1 << 18)],
    ["bench-bigjoin", "--n-left", str(1 << 20), "--n-right", str(1 << 20)],
    ["bench-bigjoin", "--n-left", str(1 << 20), "--n-right", str(1 << 20),
     "--outer"],
    ["bench-bigpipe", "--n-left", str(1 << 20), "--n-right", str(1 << 20)],
    ["bench-bigtopk", "--n", str(1 << 20), "--run-size", str(1 << 18)],
    ["bench-bigdistinct", "--n", str(1 << 20), "--run-size", str(1 << 18)],
    ["bench-bigsetops", "--n-a", str(1 << 20), "--n-b", str(1 << 20),
     "--run-size", str(1 << 18)]])
def test_big_operator_clis_on_the_card(cuda, capsys, tmp_path, argv):
    assert main(argv + ["--trace-dir", str(tmp_path)]) == 0
    row = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("{")][-1])
    assert row["verified"] and all(row["checks"].values())
    assert row["value"] > 0 and row["peak_mem_bytes"] > 0
    assert row["sort_passes"] > 0 and "H100" in row["device"]
    assert row["profile"]["by_category_ms"]["B3 rank+scatter"] > 0


# ------------------------------- out-of-core quantiles, window, ORDER BY

@pytest.mark.parametrize("key_bits", [64, 8])
def test_quantile_big_on_the_card_matches_numpy(cuda, key_bits):
    from tpu_qe_torch.hashing import keygen_hash_numpy
    from tpu_qe_torch.ops import bigquantile
    from tpu_qe_torch.ops.quantile import canon_qs, disc_rank
    n, qs = 1 << 22, [0.0, 0.01, 0.5, (3, 2), 0.99, 1.0]
    res = _launched_as_recorded(lambda: bigquantile.quantile_big(
        n, qs, run_size=1 << 20, key_bits=key_bits))
    keys = keygen_hash_numpy(np.arange(n, dtype=np.uint32))
    if key_bits < 64:
        keys &= np.uint64((1 << key_bits) - 1)
    keys.sort()
    assert res.all_ok
    np.testing.assert_array_equal(res.values, np.array(
        [keys[disc_rank(num, sh, n)] for num, sh in canon_qs(qs)],
        dtype=np.uint64))


@pytest.mark.parametrize("partitions", [1, 1 << 12])
def test_window_big_on_the_card_matches_numpy(cuda, partitions):
    from tpu_qe_torch.ops import bigwindow
    n = 1 << 22
    res, got = _launched_as_recorded(lambda: bigwindow.window_big(
        n, partitions=partitions, run_size=1 << 20, n_buckets=4,
        collect=True))
    assert res.all_ok
    idx = np.arange(n, dtype=np.uint32)
    key, o, v = bigwindow.rows_numpy(idx, partitions)
    perm = np.lexsort((idx, o, key))
    sk, so, sv = key[perm], o[perm], v[perm].astype(np.uint64)
    pos = np.arange(n)
    new = np.r_[True, sk[1:] != sk[:-1]]
    onew = new | np.r_[True, so[1:] != so[:-1]]
    ps = np.maximum.accumulate(np.where(new, pos, 0))
    p0 = np.concatenate([np.zeros(1, np.uint64), np.cumsum(sv)])
    want = {"key": sk, "order": so, "idx": perm.astype(np.uint32),
            "value": v[perm], "rn": pos - ps + 1,
            "rk": np.maximum.accumulate(np.where(onew, pos, 0)) - ps + 1,
            "cum": p0[pos + 1] - p0[ps],
            "lg": np.where(new, 0, np.r_[0, sv[:-1]])}
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].astype(np.uint64),
                                      w.astype(np.uint64), err_msg=k)


def test_order_by_big_on_the_card_matches_numpy(cuda):
    from tpu_qe_torch.ops import bigorderby
    n = 1 << 22
    res, got = _launched_as_recorded(lambda: bigorderby.order_by_big(
        n, a_card=7, run_size=1 << 20, n_buckets=4, collect=True))
    assert res.all_ok
    a, b, pay = bigorderby.rows_numpy(np.arange(n, dtype=np.uint32), 7)
    perm = np.lexsort((np.arange(n), b, ~a))
    for k, w in (("a", a[perm]), ("b", b[perm]),
                 ("idx", perm.astype(np.uint32)), ("pay", pay[perm])):
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("argv", [
    ["bench-bigquantile", "--n", str(1 << 22), "--run-size", str(1 << 20)],
    ["bench-bigquantile", "--n", str(1 << 22), "--run-size", str(1 << 20),
     "--cont"],
    ["bench-bigwindow", "--n", str(1 << 22), "--run-size", str(1 << 20)],
    ["bench-bigorderby", "--n", str(1 << 22), "--run-size", str(1 << 20)]])
def test_last_big_operator_clis_on_the_card(cuda, capsys, tmp_path, argv):
    assert main(argv + ["--trace-dir", str(tmp_path)]) == 0
    row = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("{")][-1])
    assert row["verified"] and all(row["checks"].values())
    assert row["value"] > 0 and row["peak_mem_bytes"] > 0
    assert row["sort_passes"] > 0 and "H100" in row["device"]
    assert row["profile"]["by_category_ms"]["B3 rank+scatter"] > 0


# -- the empty-input repairs (set_op, the joins) and the SQL executor ---------

def test_empty_sides_on_the_card(cuda):
    from tpu_qe_torch.ops.setops import set_op
    e = U64.from_numpy(np.zeros(0, np.uint64), cuda)
    for op in ("union", "intersect", "except"):
        keys, ca, cb, num = set_op(e, e, op)
        assert keys.lo.shape[0] == 0 and ca.numel() == 0 and int(num) == 0
    left = Table.from_numpy({"key": np.arange(3, dtype=np.uint64),
                             "a": np.arange(3, dtype=np.uint32)}, cuda)
    right = Table.from_numpy({"key": np.zeros(0, np.uint64),
                              "b": np.zeros(0, np.float32)}, cuda)
    got = tjoin.join_fk(left, right)
    assert not got.matched.any() and got.table.num_rows == 3
    assert not got.table["b"].any()
    t, m = left.join(right)
    assert t.num_rows == 3 and not m.any() and not t["b"].any()
    s = tjoin.join_fk_scan(left.drop("key"), right.drop("key"),
                           left["key"], right["key"], output="stream")
    assert s.is_left.all() and not s.matched.any()
    for lt, rt in ((left, right), (right, left)):
        assert int(tjoin.join_inner(lt, rt).num_out) == 0
        res = tjoin.join_outer(lt, rt, how="full")
        assert int(res.num_out) == lt.num_rows
        assert int(res.num_right_only) == rt.num_rows
        assert not res.matched[:lt.num_rows].any()


def test_native_streams_and_dump_loaders_on_the_card_host(cuda, tmp_path):
    from tpu_qe_torch.utils import dump
    out = native.chacha8_raw_block(bytes(32), 0)
    assert out.tobytes()[:8].hex() == "3e00ef2f895f40d6"
    assert (native.chacha8_u32(7, 64) == native.chacha8_u32(7, 64)).all()
    f = native.chacha8_f32(7, 1000)
    assert (f >= 0).all() and (f < 1).all()
    assert native.select_digit8(7, 0, 0xFF000000) == 255
    assert native.select_digit6(10, 0, 0xF0000000) == 15
    codes = np.array([0, 2**63 + 5, 2**64 - 1], np.uint64)
    p = dump.dump_morton_codes(codes, str(tmp_path / "c.txt"))
    np.testing.assert_array_equal(dump.load_morton_codes(p), codes)
    tris = np.array([[1, 2, 3], [4, 5, 6]], np.uint32)
    p = dump.dump_indices(tris, str(tmp_path / "i.txt"))
    np.testing.assert_array_equal(dump.load_indices(p), tris)


def test_sql_battery_on_the_card_matches_the_cpu_and_sqlite(cuda,
                                                             monkeypatch):
    import sql_battery as bsql
    cpu = bsql.battery(torch.device("cpu"))

    def refuse(*a, **k):
        raise AssertionError("an n-row sort left the radix kernels")
    for name in ("sort", "argsort", "unique"):
        monkeypatch.setattr(torch, name, refuse)
        monkeypatch.setattr(torch.Tensor, name, refuse)
    kernels.reset_launches()
    card = bsql.battery(cuda)
    assert kernels.LAUNCHES["rank_and_scatter"] > 0
    con = bsql.sqlite_connection(bsql.battery_tables())
    for fam, want in cpu.items():
        assert bsql.differs(card[fam], want) is None, fam
        if fam in bsql.FAMILIES:
            q, sq, ordered = bsql.FAMILIES[fam]
            assert bsql.agrees(card[fam], bsql.sqlite_rows(con, sq or q),
                               ordered) is None, fam


def test_sql_edges_on_the_card(cuda):
    from tpu_qe_torch.sql import Database
    db = Database()
    assert db.device.type == "cuda"
    v = np.array([-(1 << 31), -(1 << 31), 7, -1], np.int32)
    d = np.array([-1, 0, 0, 2], np.int32)
    u = np.array([0x80000000, 0xFFFFFFFF, 5, 0], np.uint32)
    db.register("t", {"v": v, "d": d, "u": u,
                      "k": np.arange(4, dtype=np.uint32)})
    db.register("e", {"k": np.zeros(0, np.uint32),
                      "w": np.zeros(0, np.int32)})
    out = db.sql("SELECT k, v / d AS q, v % d AS r, v / 0 AS q0, "
                 "u / 3 AS a, u % 7 AS b, u > v AS c FROM t ORDER BY k")
    np.testing.assert_array_equal(out["q"], [-(1 << 31), -(1 << 31), 7, 0])
    np.testing.assert_array_equal(out["r"], [0, 0, 0, -1])
    np.testing.assert_array_equal(out["q0"], v)
    np.testing.assert_array_equal(out["a"], u // 3)
    np.testing.assert_array_equal(out["b"], u % 7)
    np.testing.assert_array_equal(out["c"], [True, True, False, True])
    assert len(db.sql("SELECT k FROM e UNION SELECT k FROM e")["k"]) == 0
    assert len(db.sql("SELECT t.k FROM t JOIN e ON t.k = e.k")["k"]) == 0
    out = db.sql("SELECT t.k, e.w, e__matched FROM t LEFT JOIN e "
                 "ON t.k = e.k ORDER BY k")
    np.testing.assert_array_equal(out["k"], np.arange(4))
    assert not out["w"].any() and not out["e__matched"].any()


# ------------------------------- the out-of-core SQL tier (virtual tables)

BIG_FAMILIES = sorted(importlib.import_module("sql_big_battery").FAMILIES)


@pytest.fixture(scope="module")
def _big_cpu():
    import sql_big_battery as bb
    return bb.database(torch.device("cpu"))


@pytest.mark.parametrize("fam", BIG_FAMILIES)
def test_sql_big_family_on_the_card_matches_the_cpu(cuda, _big_cpu, fam,
                                                    monkeypatch):
    # integers bit-equal, floats within rtol 1e-5 (atol 1e-3), as
    # tests/sql_big_battery.py states; no n-row sort leaves B1-B3
    import sql_big_battery as bb
    from tpu_qe_torch.sort import driver
    q, ordered = bb.FAMILIES[fam]
    want = _big_cpu.sql(q, run_size=bb.RUN)
    db = bb.database(cuda)

    def refuse(*a, **k):
        raise AssertionError("an n-row sort left the radix kernels")
    for name in ("sort", "argsort", "unique"):
        monkeypatch.setattr(torch, name, refuse)
        monkeypatch.setattr(torch.Tensor, name, refuse)
    kernels.reset_launches()
    driver.RADIX_PASSES.clear()
    got = db.sql(q, run_size=bb.RUN)
    torch.cuda.synchronize()
    passes = sum(driver.RADIX_PASSES.values())
    assert (passes > 0) == (fam != "head_where")   # a head sorts nothing
    assert kernels.LAUNCHES["rank_and_scatter"] == passes
    assert kernels.LAUNCHES["block_histogram"] == passes
    assert bb.differs(got, want, ordered) is None, fam


@pytest.mark.parametrize("argv", [
    ["--verb", v] for v in ("groupby", "orderby", "head", "distinct",
                            "countdistinct", "join", "window", "setops",
                            "range", "vvjoin")] + [["--median"], ["--where"]])
def test_bench_bigsql_cli_on_the_card(cuda, capsys, tmp_path, argv):
    rc = main(["bench-bigsql", "--n", str(1 << 20), "--run-size",
               str(1 << 16), "--groups", "64", "--trace-dir",
               str(tmp_path)] + argv)
    row = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("{")][-1])
    assert rc == 0 and row["verified"] is True
    assert row["value"] > 0 and row["peak_mem_bytes"] > 0
    assert "H100" in row["device"] and row["power_limit"]
    assert (row["sort_passes"] > 0) == (argv[-1] != "head")


# ------------------------------- the exchange layer on a mesh of shards

def _refuse_torch_sorts(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("an n-row sort left the radix kernels")
    for name in ("sort", "argsort", "unique"):
        monkeypatch.setattr(torch, name, refuse)
        monkeypatch.setattr(torch.Tensor, name, refuse)


def _launches_match_passes():
    from tpu_qe_torch.sort import driver
    torch.cuda.synchronize()
    passes = sum(driver.RADIX_PASSES.values())
    return passes > 0 and all(kernels.LAUNCHES[k] == passes for k in (
        "block_histogram", "exclusive_scan", "rank_and_scatter"))


@pytest.mark.parametrize("cf,overlap", [("auto", 1), (3.0, 2), (4.0, 4)])
def test_distributed_sort_on_a_local_mesh_of_8(cuda, monkeypatch, cf,
                                               overlap):
    from tpu_qe_torch.exchange import LocalMesh, distributed_sort_numpy
    from tpu_qe_torch.sort import driver
    keys = _keys(1 << 21, 17)
    keys[::7] = keys[0]
    pay = np.arange(len(keys), dtype=np.uint32)
    _refuse_torch_sorts(monkeypatch)
    kernels.reset_launches()
    driver.RADIX_PASSES.clear()
    k, p = distributed_sort_numpy(keys, pay, LocalMesh(8, cuda),
                                  capacity_factor=cf, overlap=overlap)
    assert _launches_match_passes()
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(k, keys[order])
    np.testing.assert_array_equal(p, order.astype(np.uint32))


def test_distributed_sort_overflow_raises_on_the_card(cuda):
    from tpu_qe_torch.exchange import LocalMesh, distributed_sort_numpy
    keys = np.arange(1 << 20, 0, -1).astype(np.uint64)
    with pytest.raises(RuntimeError, match="capacity"):
        distributed_sort_numpy(keys, None, LocalMesh(8, cuda),
                               capacity_factor=1.0)


def _dops_family(mesh):
    from tpu_qe_torch.exchange import dops
    rng = np.random.default_rng(23)
    n = 1 << 16
    keys = rng.integers(0, 1 << 12, n).astype(np.uint64) << np.uint64(20)
    vals = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    fvals = rng.standard_normal(n).astype(np.float32)
    rkeys = np.unique(rng.integers(0, 1 << 40, 2 * n, dtype=np.uint64))[
        :n // 4]
    rvals = rng.integers(0, 1 << 30, len(rkeys), dtype=np.uint32)
    lkeys = rkeys[rng.integers(0, len(rkeys), n)]
    lkeys[:n // 3] = rkeys[0]
    lkeys[1::5] |= np.uint64(1) << np.uint64(45)        # misses
    aggs = ("count", "sum", "min", "max")
    return {
        "join_fk": dops.distributed_join_fk_numpy(
            lkeys, [vals], rkeys, [rvals], mesh, capacity_factor="auto"),
        "join_inner": dops.distributed_join_inner_numpy(
            keys, [vals], keys[:n // 2], [vals[:n // 2]], mesh,
            capacity_factor="auto", out_budget_factor=64.0),
        "join_outer": dops.distributed_join_outer_numpy(
            lkeys, [vals], rkeys[::2], [rvals[::2]], mesh, full=True,
            capacity_factor="auto"),
        "top_k": dops.distributed_top_k_numpy(keys, [vals], mesh, 1000),
        "top_k_largest": dops.distributed_top_k_numpy(keys, [vals], mesh,
                                                      1000, largest=True),
        "aggregate": dops.distributed_aggregate_numpy(
            keys, vals, mesh, aggs=aggs, capacity_factor="auto"),
        "aggregate_f32": dops.distributed_aggregate_numpy(
            keys, fvals, mesh, aggs=aggs, capacity_factor="auto"),
        "count_distinct": dops.distributed_count_distinct_numpy(
            keys, vals % np.uint32(97), mesh, capacity_factor="auto"),
        "join_aggregate": dops.distributed_join_aggregate_numpy(
            lkeys, rkeys, rvals, mesh, capacity_factor="auto"),
        **{f"set_{op}": dops.distributed_set_op_numpy(
            keys, keys[:n // 4] + np.uint64(1 << 20), mesh, op=op,
            capacity_factor="auto")
           for op in ("union", "intersect", "except")},
    }


def _rows(out):
    """Sorted rows of an output in no particular order (inner / outer)."""
    g, lcols, rcols = out[:3]
    cols = [g] + list(lcols) + list(rcols) + list(out[3:4])
    order = np.lexsort(cols[::-1])
    return [c[order] for c in cols]


def test_dops_family_on_the_card_matches_the_cpu(cuda, monkeypatch):
    # integers bit for bit, float sums within rtol 1e-5; no n-row sort
    # leaves the radix kernels
    from tpu_qe_torch.exchange import LocalMesh
    from tpu_qe_torch.sort import driver
    want = _dops_family(LocalMesh(8, "cpu"))
    _refuse_torch_sorts(monkeypatch)
    kernels.reset_launches()
    driver.RADIX_PASSES.clear()
    got = _dops_family(LocalMesh(8, cuda))
    assert _launches_match_passes()
    for name in ("join_inner", "join_outer"):
        for g, w in zip(_rows(got[name]), _rows(want[name])):
            np.testing.assert_array_equal(g, w, err_msg=name)
    got["join_outer"] = got["join_outer"][4:]
    want["join_outer"] = want["join_outer"][4:]
    for name in ("join_fk", "top_k", "top_k_largest", "set_union",
                 "set_intersect", "set_except"):
        for g, w in zip(got[name], want[name]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=name)
    for name in ("aggregate", "count_distinct", "join_aggregate"):
        assert got[name] == want[name], name
    g, w = got["aggregate_f32"], want["aggregate_f32"]
    assert g.keys() == w.keys()
    for k in w:
        assert {a: g[k][a] for a in ("count", "min", "max")} == {
            a: w[k][a] for a in ("count", "min", "max")}
        np.testing.assert_allclose(g[k]["sum"], w[k]["sum"], rtol=1e-5,
                                   atol=1e-3)


def test_group_mesh_over_nccl_at_world_size_1(cuda):
    import torch.distributed as dist
    from tpu_qe_torch.exchange import (GroupMesh, LocalMesh,
                                       distributed_sort_numpy, make_mesh)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        gm, lm = make_mesh(), LocalMesh(1, cuda)
        assert isinstance(gm, GroupMesh) and gm.n_dev == 1
        x = torch.arange(12, dtype=torch.int32, device=cuda).reshape(1, 12)
        blocks = x.reshape(1, 1, 12)
        assert torch.equal(gm.all_gather(x), lm.all_gather(x))
        assert torch.equal(gm.all_to_all(blocks), lm.all_to_all(blocks))
        w = torch.tensor([7], device=cuda)
        assert torch.equal(gm.pmax(w), lm.pmax(w))
        keys = _keys(1 << 20, 5)
        k, p = distributed_sort_numpy(keys, np.arange(1 << 20,
                                                      dtype=np.uint32), gm)
        order = np.argsort(keys, kind="stable")
        np.testing.assert_array_equal(k, keys[order])
        np.testing.assert_array_equal(p, order.astype(np.uint32))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("devices", [[], ["--devices", "8"]])
def test_bench_matrix_dsort_on_the_card(cuda, capsys, devices):
    assert main(["bench-matrix", "--configs", "dsort", "--scale", "0.0625"]
                + devices) == 0
    row = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("{")][-1])
    assert all(row["checks"].values()) and row["value"] > 0
    assert row["devices"] == (8 if devices else torch.cuda.device_count())


# ---- the rest of the exchange layer and the distributed out-of-core sort

def _dwindow_case():
    rng = np.random.default_rng(31)
    n = 1 << 16
    keys = rng.integers(0, 37, n).astype(np.uint64)
    keys[::5] = 11                                   # a hot partition
    keys[::97] = np.uint64((1 << 64) - 1)
    order = (rng.integers(-8, 8, n) + (1 << 31)).astype(np.uint32)
    vals = {"vu": rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
                np.uint32),
            "vi": rng.integers(-(1 << 31), (1 << 31) - 1, n,
                               dtype=np.int64).astype(np.int32),
            "vf": rng.random(n).astype(np.float32)}
    funcs = {"rn": ("row_number",), "rk": ("rank",), "dr": ("dense_rank",),
             "pr": ("percent_rank",), "nt": ("ntile", 5),
             "cs": ("running_sum", "vu"), "csi": ("running_sum", "vi"),
             "csf": ("running_sum", "vf"), "cm": ("running_min", "vi"),
             "lg": ("lag", "vu", 3), "lg3": ("lag", "vi", 0, 3),
             "ld": ("lead", "vf", 0.5), "ld2": ("lead", "vu", 7, 2),
             "fv": ("first_value", "vu"), "lv": ("last_value", "vi"),
             "ms": ("moving_sum", "vu", 4), "mf": ("moving_min", "vi", 3, 2),
             "mc": ("moving_count", 4, 1), "ts": ("total_sum", "vi"),
             "tx": ("total_max", "vf"), "pc": ("partition_count",),
             "ta": ("total_avg", "vu"), "ra": ("running_avg", "vi"),
             "rs": ("range_sum", "vu", "unbounded"),
             "rm": ("range_min", "vi", "unbounded")}
    floats = ("pr", "csf", "ta", "ra")
    return keys, order, vals, funcs, floats


def test_distributed_window_on_the_card_matches_the_cpu(cuda, monkeypatch):
    # integers bit for bit, float sums and averages within the reference's
    # tolerance (rtol 2e-4, atol 1e-3); no n-row sort leaves the kernels
    from tpu_qe_torch.exchange import LocalMesh, distributed_window_numpy
    from tpu_qe_torch.sort import driver
    keys, order, vals, funcs, floats = _dwindow_case()
    want = distributed_window_numpy(keys, funcs, LocalMesh(8, "cpu"),
                                    order=order, values=vals,
                                    capacity_factor="auto")
    _refuse_torch_sorts(monkeypatch)
    kernels.reset_launches()
    driver.RADIX_PASSES.clear()
    got = distributed_window_numpy(keys, funcs, LocalMesh(8, cuda),
                                   order=order, values=vals,
                                   capacity_factor="auto")
    assert _launches_match_passes()
    for nm in funcs:
        if nm in floats:
            np.testing.assert_allclose(got[nm], want[nm], rtol=2e-4,
                                       atol=1e-3, err_msg=nm)
        else:
            np.testing.assert_array_equal(got[nm], want[nm], err_msg=nm)


def test_distributed_order_by_on_the_card_matches_the_cpu(cuda,
                                                          monkeypatch):
    from tpu_qe_torch.exchange import LocalMesh, distributed_order_by_numpy
    from tpu_qe_torch.sort import driver
    keys, order, vals, _, _ = _dwindow_case()
    cols = {"k": keys, "o": order, "vi": vals["vi"], "vf": vals["vf"],
            "i": np.arange(len(keys), dtype=np.uint32)}
    by = [("k", "desc"), "o", ("vf", "desc")]
    want = distributed_order_by_numpy(cols, by, LocalMesh(8, "cpu"),
                                      capacity_factor="auto")
    _refuse_torch_sorts(monkeypatch)
    kernels.reset_launches()
    driver.RADIX_PASSES.clear()
    got = distributed_order_by_numpy(cols, by, LocalMesh(8, cuda),
                                     capacity_factor="auto")
    assert _launches_match_passes()
    np.testing.assert_array_equal(got[1], want[1])
    for nm in cols:
        np.testing.assert_array_equal(got[0][nm], want[0][nm], err_msg=nm)


def _dquantile_family(mesh):
    from tpu_qe_torch.exchange import dquantile as dq
    rng = np.random.default_rng(41)
    n = 1 << 16
    u64 = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    u64[::9] = np.uint64((1 << 64) - 1)
    f32 = rng.standard_normal(n).astype(np.float32)
    keys = rng.integers(0, 37, n).astype(np.uint64)
    qs = [0.0, 0.25, (1, 1), 0.99, 1.0]
    cont = dq.distributed_quantile_cont_numpy(f32, qs, mesh)
    return {
        "u64": dq.distributed_quantile_numpy(u64, qs, mesh),
        "f32": dq.distributed_quantile_numpy(f32, qs, mesh),
        "cont": (cont.lower.cpu().numpy(), cont.upper.cpu().numpy(),
                 cont.frac_num, cont.value.cpu().numpy()),
        "group": dq.distributed_group_quantile_numpy(
            keys, (u64 >> np.uint64(33)).astype(np.uint32), qs, mesh,
            max_groups=64),
        "group_cont": dq.distributed_group_quantile_cont_numpy(
            keys, f32, qs, mesh, max_groups=64),
    }


def test_distributed_quantiles_on_the_card_match_the_cpu(cuda, monkeypatch):
    from tpu_qe_torch.exchange import LocalMesh
    from tpu_qe_torch.sort import driver
    want = _dquantile_family(LocalMesh(8, "cpu"))
    _refuse_torch_sorts(monkeypatch)
    kernels.reset_launches()
    driver.RADIX_PASSES.clear()
    got = _dquantile_family(LocalMesh(8, cuda))
    assert _launches_match_passes()
    np.testing.assert_array_equal(got["u64"], want["u64"])
    np.testing.assert_array_equal(got["f32"], want["f32"])
    for g, w in zip(got["cont"], want["cont"]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert got["group"] == want["group"]
    assert got["group_cont"].keys() == want["group_cont"].keys()
    for k, w in want["group_cont"].items():
        np.testing.assert_array_equal(np.array(got["group_cont"][k]),
                                      np.array(w))


@pytest.mark.parametrize("n_dev,key_bits,payload_cols",
                         [(8, 64, 1), (4, 5, 3), (1, 64, 2)])
def test_sort_big_distributed_on_the_card_matches_the_cpu(
        cuda, monkeypatch, n_dev, key_bits, payload_cols):
    from tpu_qe_torch.exchange import LocalMesh
    from tpu_qe_torch.sort import driver
    from tpu_qe_torch.sort.dbigsort import sort_big_distributed
    n = n_dev * 4 * (1 << 14)
    kw = dict(run_size=1 << 14, buckets_per_dev=3, key_bits=key_bits,
              collect=True, payload_cols=payload_cols, force_composed=True)
    wres, want = sort_big_distributed(n, LocalMesh(n_dev, "cpu"), **kw)
    _refuse_torch_sorts(monkeypatch)
    kernels.reset_launches()
    driver.RADIX_PASSES.clear()
    res, got = sort_big_distributed(n, LocalMesh(n_dev, cuda), **kw)
    assert _launches_match_passes()
    assert res.all_ok and wres.all_ok
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    if payload_cols > 1:
        for g, w in zip(got[2], want[2]):
            np.testing.assert_array_equal(g, w)


def test_bench_big_distributed_cli_on_the_card(cuda, capsys):
    assert main(["bench-big", "--distributed", "--devices", "8", "--n",
                 str(1 << 24), "--run-size", str(1 << 20)]) == 0
    row = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("{")][-1])
    assert row["verified"] and all(row["checks"].values())
    assert row["devices"] == 8 and row["balance"] >= 1.0
    assert row["metric"].startswith("distributed out-of-core")


def test_group_mesh_psum_over_nccl_at_world_size_1(cuda):
    import torch.distributed as dist
    from tpu_qe_torch.exchange import LocalMesh, make_mesh
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        gm, lm = make_mesh(), LocalMesh(1, cuda)
        x = torch.tensor([[3, 1 << 40, -9]], device=cuda)
        assert torch.equal(gm.psum(x), lm.psum(x))
        y = torch.arange(6, dtype=torch.int32, device=cuda).reshape(1, 6)
        assert torch.equal(gm.psum(y), lm.psum(y))
    finally:
        dist.destroy_process_group()


def _plain(x):
    """A result without its times (dataclasses as dicts of their other
    fields, recursively), for comparing the card's run with the CPU's."""
    import dataclasses
    if dataclasses.is_dataclass(x):
        return {k: _plain(v) for k, v in dataclasses.asdict(x).items()
                if not (k.endswith("_s") or k == "seconds")}
    if isinstance(x, (tuple, list)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.tolist())
    return x


_RUN = 1 << 14          # four shards of two runs: 2^17 rows a side


def _dbig_case(name, mesh):
    from tpu_qe_torch.ops import (dbigagg, dbigdistinct, dbigjoin,
                                  dbigorderby, dbigpipe, dbigquantile,
                                  dbigsetops, dbigtopk, dbigwindow)
    n = mesh.n_dev * 2 * _RUN
    if name == "agg":
        return dbigagg.aggregate_big_distributed(
            n, mesh, n_groups=1 << 12, run_size=_RUN, collect=True,
            minmax=True)
    if name == "join":
        return dbigjoin.join_big_distributed(n, n, mesh, run_size=_RUN,
                                             buckets_per_dev=3)
    if name == "pipe":
        return dbigpipe.join_aggregate_big_distributed(
            n, n // 2, mesh, n_groups=1 << 10, run_size=_RUN // 2,
            collect=True)
    if name == "topk":
        return dbigtopk.top_k_big_distributed(n, 100, mesh, run_size=_RUN,
                                              largest=True, collect=True)
    if name == "distinct":
        return dbigdistinct.count_distinct_big_distributed(
            n, mesh, n_groups=1 << 10, n_values=37, run_size=_RUN,
            collect=True)
    if name == "setops":
        return [dbigsetops.set_op_big_distributed(
            op, n, n, mesh, g_a=3 << 10, g_b=1 << 11, offset=1 << 10,
            run_size=_RUN, collect=True)
            for op in ("union", "intersect", "except")]
    if name == "quantile":
        return (dbigquantile.quantile_big_distributed(
            n, [0.0, 0.01, (1, 1), 0.99, 1.0], mesh, run_size=_RUN),
            dbigquantile.quantile_cont_big_distributed(
                n, [(1, 1), (3, 2)], mesh, run_size=_RUN, key_bits=8))
    if name == "window":
        return dbigwindow.window_big_distributed(
            n, mesh, partitions=3, run_size=_RUN, buckets_per_dev=2,
            collect=True)
    assert name == "orderby"
    return dbigorderby.order_by_big_distributed(
        n, mesh, a_card=7, run_size=_RUN, buckets_per_dev=2, collect=True)


@pytest.mark.parametrize("name", ["agg", "join", "pipe", "topk", "distinct",
                                  "setops", "quantile", "window", "orderby"])
def test_dbig_operators_on_a_local_mesh_of_4_match_the_cpu(cuda, monkeypatch,
                                                           name):
    # every distributed out-of-core operator on LocalMesh(4) of the card:
    # each result field but the times, and every collected table, equal
    # the same operator's on LocalMesh(4) of the CPU; no torch sort runs
    # and B1-B3 launch once per recorded pass
    from tpu_qe_torch.exchange import LocalMesh
    from tpu_qe_torch.sort import driver
    want = _plain(_dbig_case(name, LocalMesh(4, "cpu")))
    _refuse_torch_sorts(monkeypatch)
    kernels.reset_launches()
    driver.RADIX_PASSES.clear()
    got = _plain(_dbig_case(name, LocalMesh(4, cuda)))
    assert _launches_match_passes()
    assert got == want


@pytest.mark.parametrize("cmd", ["bench-bigagg", "bench-bigjoin",
                                 "bench-bigpipe", "bench-bigtopk",
                                 "bench-bigdistinct", "bench-bigsetops",
                                 "bench-bigquantile", "bench-bigwindow",
                                 "bench-bigorderby"])
def test_bigops_distributed_cli_on_the_card(cuda, capsys, cmd):
    sizes = {"bench-bigjoin": ["--n-left", "2097152", "--n-right",
                               "2097152"],
             "bench-bigpipe": ["--n-left", "2097152", "--n-right",
                               "2097152"],
             "bench-bigsetops": ["--n-a", "2097152", "--n-b", "2097152",
                                 "--g-a", "65536", "--g-b", "65536",
                                 "--offset", "32768"]}
    argv = [cmd, "--distributed", "--devices", "8", "--run-size",
            str(1 << 18)] + sizes.get(cmd, ["--n", str(1 << 22)])
    assert main(argv) == 0
    row = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("{")][-1])
    assert row["verified"] and row["devices"] == 8
    assert row["metric"].endswith(", 8 devices")
    assert row["peak_mem_bytes"] > 0 and row["time_s"] > 0


@pytest.mark.parametrize("op", ["fk", "inner", "outer_full",
                                "join_aggregate", "set_op"])
def test_exchange_with_an_empty_side_on_the_card(cuda, op):
    # Queue C 21 and 22 on the card: a join with no right rows, and a set
    # op with no rows at all, answer as on LocalMesh(2) of the CPU
    from tpu_qe_torch.exchange import LocalMesh, dops
    keys = np.arange(1, 17, dtype=np.uint64) * np.uint64(7)
    vals = np.arange(16, dtype=np.uint32) + 5
    ek, ev = np.zeros(0, np.uint64), np.zeros(0, np.uint32)

    def run(mesh):
        kw = {"capacity_factor": "auto"}
        if op == "fk":
            return dops.distributed_join_fk_numpy(keys, [vals], ek, [ev],
                                                  mesh, **kw)
        if op == "inner":
            return dops.distributed_join_inner_numpy(keys, [vals], ek, [ev],
                                                     mesh, **kw)
        if op == "outer_full":
            return dops.distributed_join_outer_numpy(ek, [ev], keys, [vals],
                                                     mesh, full=True, **kw)
        if op == "join_aggregate":
            return dops.distributed_join_aggregate_numpy(keys, ek, ev, mesh,
                                                         **kw)
        return dops.distributed_set_op_numpy(ek, ek, mesh, **kw)
    assert _plain(run(LocalMesh(2, cuda))) == _plain(run(LocalMesh(2,
                                                                   "cpu")))


@pytest.mark.parametrize("name", ["group_by_aggregates", "percentiles",
                                  "where_with_join_left", "window",
                                  "whole_partition_frames", "order_by_limit",
                                  "where_order_by_float_key_desc",
                                  "set_op_except_all"])
def test_sql_mesh_on_a_local_mesh_of_8_equals_in_core(cuda, monkeypatch,
                                                      name):
    # Database.sql(q, mesh=LocalMesh(8) of the card) against the in-core
    # answer on the card (integers bit for bit, floats at the family's
    # rtol), no torch sort in the mesh= call and B1-B3 launched once per
    # recorded pass
    import sql_dist_battery as B
    from tpu_qe_torch.exchange import LocalMesh
    from tpu_qe_torch.sort import driver
    from tpu_qe_torch.sql import Database
    f = B.FAMILIES[name]
    db = Database(cuda)
    for nm, cols in B.tables(f.seed_for(8), n=1 << 16, m=1 << 12).items():
        db.register(nm, cols)
    want = db.sql(f.sql)
    with monkeypatch.context() as m:
        _refuse_torch_sorts(m)
        kernels.reset_launches()
        driver.RADIX_PASSES.clear()
        got = db.sql(f.sql, mesh=LocalMesh(8, cuda))
        assert _launches_match_passes()
    B.compare(want, got, rtol=f.rtol, ordered=f.ordered)
