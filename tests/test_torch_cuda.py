"""The CUDA kernels of tpu_qe_torch on the card, against their plain
PyTorch twins on the same card and the C++ oracles (tolerance: exact
equality). Every test here needs a CUDA card and skips without one.

On a machine with the card (which need not have JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

This file imports nothing of JAX or tpu_qe.
"""

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
