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

from tpu_qe_torch import kernels, native  # noqa: E402
from tpu_qe_torch.__main__ import main  # noqa: E402
from tpu_qe_torch.bits import U64  # noqa: E402
from tpu_qe_torch.kernels import histogram as hk  # noqa: E402
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
    assert kernels.LAUNCHES == {"block_histogram": 1, "exclusive_scan": 1,
                                "block_rank_and_histogram": 1,
                                "rank_and_scatter": 1}


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
