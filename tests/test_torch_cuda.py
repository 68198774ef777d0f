"""The CUDA kernels of tpu_qe_torch on the card, against their plain
PyTorch twins on the same card and the C++ oracles (tolerance: exact
equality). Every test here needs a CUDA card and skips without one.

On a machine with the card (which need not have JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

This file imports nothing of JAX or tpu_qe.
"""

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
        hk.block_histogram(k.lo, k.hi, 0, 9)   # the twin takes 16 bits
    hist = hk.block_histogram(k.lo, k.hi, 0, 8)
    base = sk.exclusive_scan(hist.reshape(-1))
    with pytest.raises(ValueError):
        hk.rank_and_scatter(k.lo, k.hi, [k.lo] * 9, base, 0, 8)


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


@pytest.mark.parametrize("block", [1024, 4096, 1000])
@pytest.mark.parametrize("n", [0, 1, 1023, 100_003])
def test_rank_mxu_kernel_matches_twin_and_b3(cuda, n, block):
    rng = np.random.default_rng(n + block)
    for keys in (rng.integers(0, 1 << 64, n, dtype=np.uint64),
                 rng.integers(0, 2, n, dtype=np.uint64),
                 np.full(n, 0x5A, dtype=np.uint64)):
        k = U64.from_numpy(keys, cuda)
        for shift in (0, 28, 56):
            r, h = rk.block_rank_and_histogram_mxu(k.lo, k.hi, shift, block)
            tr, th = rk.block_rank_and_histogram_mxu_plain(k.lo, k.hi, shift,
                                                           block)
            r3, h3 = hk.block_rank_and_histogram(k.lo, k.hi, shift, 8, block)
            for a, b in ((r, tr), (h, th), (r, r3), (h, h3)):
                _same(a, b)


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
                 "block_rank_r256", "bitonic_chunk8192"):
        assert f'"kernel {name}"' in out
