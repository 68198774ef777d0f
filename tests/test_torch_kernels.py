"""The port's kernel entry points on CPU tensors (their plain PyTorch twins)
against the JAX Pallas kernels, run in interpret mode as the JAX package's
own tests run them, and against the C++ oracles. Inputs come from numpy
seeds; every comparison is integer, so the tolerance is exact equality.

The CUDA kernels themselves are held against these twins on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_qe import native as jnative  # noqa: E402
from tpu_qe.kernels.histogram import (  # noqa: E402
    block_histogram as jax_block_histogram,
    block_rank_and_histogram as jax_block_rank)
from tpu_qe.kernels.scan import exclusive_scan as jax_exclusive_scan  # noqa: E402
from tpu_qe_torch import native  # noqa: E402
from tpu_qe_torch.bits import U64  # noqa: E402
from tpu_qe_torch.kernels import LAUNCHES  # noqa: E402
from tpu_qe_torch.kernels import histogram as hk  # noqa: E402
from tpu_qe_torch.kernels import scan as sk  # noqa: E402

DIGITS = [(0, 8), (24, 8), (32, 8), (56, 8), (30, 6), (60, 4)]
SIZES = [1, 255, 1023, 1024, 1025, 3000]
BLOCK = 1024          # the JAX kernels' tile; the port takes any block
ONES = np.uint64(0xFFFFFFFFFFFFFFFF)


def _keys(n, seed):
    return np.random.default_rng(seed).integers(0, 1 << 64, n,
                                                dtype=np.uint64)


def _u32(t):
    return t.numpy().view(np.uint32)


def _padded(keys, block=BLOCK):
    """Sentinel-padded (nb, block) u32 planes for the JAX kernels."""
    nb = -(-len(keys) // block)
    p = np.full(nb * block, ONES, dtype=np.uint64)
    p[:len(keys)] = keys
    lo = (p & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(nb, block)
    hi = (p >> np.uint64(32)).astype(np.uint32).reshape(nb, block)
    return p, lo, hi


def _native_ranks(keys, shift, bits, block):
    """Per-block stable ranks from the counting oracle: rank the combined
    (block, digit) key, which restarts the count in every block."""
    radix = 1 << bits
    d = ((keys >> np.uint64(shift)) & np.uint64(radix - 1)).astype(np.int64)
    b = np.arange(len(keys), dtype=np.int64) // block
    nb = -(-len(keys) // block)
    return native.block_rank((b * radix + d).astype(np.uint32), nb * radix)


def test_native_binding_matches_jax_binding():
    keys = _keys(3000, 1)
    np.testing.assert_array_equal(native.lsd_sort(keys), jnative.lsd_sort(keys))
    np.testing.assert_array_equal(
        native.digit_major_histogram(keys, 3, 8, 1024),
        jnative.digit_major_histogram(keys, 3, 8, 1024))
    np.testing.assert_array_equal(native.scatter_locations(keys, 5, 6, 512),
                                  jnative.scatter_locations(keys, 5, 6, 512))
    for a, b in zip(native.scene_generate(100, 300, 7),
                    jnative.scene_generate(100, 300, 7)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(native.pipeline_oracle(100, 300, 7),
                    jnative.pipeline_oracle(100, 300, 7)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("shift,bits", DIGITS)
def test_block_histogram_matches_native(shift, bits, n):
    keys = _keys(n, n + shift)
    k = U64.from_numpy(keys, "cpu")
    got = hk.block_histogram(k.lo, k.hi, shift, bits, block=BLOCK)
    assert got.shape == (1 << bits, -(-n // BLOCK))
    np.testing.assert_array_equal(
        _u32(got), native.digit_major_histogram(keys, shift // bits, bits,
                                                BLOCK))


@pytest.mark.parametrize("shift,bits", DIGITS)
def test_block_histogram_matches_jax(shift, bits):
    padded, lo, hi = _padded(_keys(3000, shift))
    k = U64.from_numpy(padded, "cpu")
    got = hk.block_histogram(k.lo, k.hi, shift, bits, block=BLOCK)
    want = np.asarray(jax_block_histogram(lo, hi, shift, bits))
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("shift,bits", DIGITS)
def test_block_rank_matches_native(shift, bits, n):
    keys = _keys(n, 7 * n + bits)
    k = U64.from_numpy(keys, "cpu")
    ranks, hist = hk.block_rank_and_histogram(k.lo, k.hi, shift, bits,
                                              block=BLOCK)
    np.testing.assert_array_equal(_u32(ranks),
                                  _native_ranks(keys, shift, bits, BLOCK))
    np.testing.assert_array_equal(
        _u32(hist), native.digit_major_histogram(keys, shift // bits, bits,
                                                 BLOCK))


@pytest.mark.parametrize("shift,bits", DIGITS)
def test_block_rank_matches_jax(shift, bits):
    padded, lo, hi = _padded(_keys(3000, 100 + shift))
    k = U64.from_numpy(padded, "cpu")
    ranks, hist = hk.block_rank_and_histogram(k.lo, k.hi, shift, bits,
                                              block=BLOCK)
    jr, jh = jax_block_rank(lo, hi, shift, bits)
    np.testing.assert_array_equal(_u32(ranks), np.asarray(jr).reshape(-1))
    np.testing.assert_array_equal(_u32(hist), np.asarray(jh))


def test_rank_is_stable_on_a_skewed_block():
    # every key has digit 0x5A: ranks are 0..B-1 in input order per block
    keys = (_keys(2500, 3) & ~np.uint64(0xFF)) | np.uint64(0x5A)
    k = U64.from_numpy(keys, "cpu")
    ranks, hist = hk.block_rank_and_histogram(k.lo, k.hi, 0, 8, block=BLOCK)
    np.testing.assert_array_equal(_u32(ranks), np.arange(2500) % BLOCK)
    np.testing.assert_array_equal(_u32(hist)[0x5A], [1024, 1024, 452])
    assert _u32(hist).sum() == 2500


@pytest.mark.parametrize("n", [1024, 4096, 8192])
def test_exclusive_scan_matches_jax(n):
    x = np.random.default_rng(n).integers(0, 1 << 32, n,
                                          dtype=np.uint64).astype(np.uint32)
    got = sk.exclusive_scan(torch.from_numpy(x.view(np.int32)))
    np.testing.assert_array_equal(_u32(got), np.asarray(jax_exclusive_scan(x)))


@pytest.mark.parametrize("n", SIZES + [0])
def test_exclusive_scan_wraps_mod_2_32(n):
    x = np.random.default_rng(n).integers(1 << 31, 1 << 32, n,
                                          dtype=np.uint64)
    got = sk.exclusive_scan(torch.from_numpy(x.astype(np.uint32).view(
        np.int32)))
    want = (np.cumsum(x) - x) & np.uint64(0xFFFFFFFF)
    np.testing.assert_array_equal(_u32(got), want.astype(np.uint32))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("shift,bits", DIGITS)
def test_scatter_destinations_in_range_and_match_native(shift, bits, n):
    keys = _keys(n, 3 * n + shift)
    k = U64.from_numpy(keys, "cpu")
    hist = hk.block_histogram(k.lo, k.hi, shift, bits, block=BLOCK)
    base = sk.exclusive_scan(hist.reshape(-1))
    dest = hk.scatter_destinations_plain(k.lo, k.hi, base, shift, bits,
                                         block=BLOCK)
    assert int(dest.min()) >= 0 and int(dest.max()) < n
    assert len(torch.unique(dest)) == n
    np.testing.assert_array_equal(
        dest.numpy(), native.scatter_locations(keys, shift // bits, bits,
                                               BLOCK).astype(np.int64))


@pytest.mark.parametrize("n", [1, 1025, 3000])
def test_rank_and_scatter_is_one_stable_pass(n):
    keys = _keys(n, n)
    k = U64.from_numpy(keys, "cpu")
    pay = torch.arange(n, dtype=torch.int32)
    pay2 = torch.from_numpy(np.random.default_rng(n).integers(
        0, 1 << 31, n).astype(np.int32))
    hist = hk.block_histogram(k.lo, k.hi, 24, 8, block=BLOCK)
    base = sk.exclusive_scan(hist.reshape(-1))
    lo, hi, (p1, p2) = hk.rank_and_scatter(k.lo, k.hi, [pay, pay2], base,
                                           24, 8, block=BLOCK)
    order = np.argsort((keys >> np.uint64(24)) & np.uint64(0xFF),
                       kind="stable")
    np.testing.assert_array_equal(U64(lo, hi).to_numpy(), keys[order])
    np.testing.assert_array_equal(p1.numpy(), order)
    np.testing.assert_array_equal(p2.numpy(), pay2.numpy()[order])


def test_cpu_tensors_launch_no_kernel():
    before = dict(LAUNCHES)
    k = U64.from_numpy(_keys(100, 0), "cpu")
    hist = hk.block_histogram(k.lo, k.hi, 0, 8)
    hk.block_rank_and_histogram(k.lo, k.hi, 0, 8)
    base = sk.exclusive_scan(hist.reshape(-1))
    hk.rank_and_scatter(k.lo, k.hi, [], base, 0, 8)
    assert LAUNCHES == before


def test_entry_points_reject_bad_planes():
    k = U64.from_numpy(_keys(100, 0), "cpu")
    with pytest.raises(ValueError):
        hk.block_histogram(k.lo.to(torch.int64), k.hi, 0, 8)
    with pytest.raises(ValueError):
        hk.block_histogram(k.lo, k.hi[:50], 0, 8)
    with pytest.raises(ValueError):
        hk.block_histogram(k.lo, k.hi, 0, 8, block=0)
    hist = hk.block_histogram(k.lo, k.hi, 0, 8)
    with pytest.raises(ValueError):   # base must cover radix * nb words
        hk.rank_and_scatter(k.lo, k.hi, [], hist.reshape(-1)[:10], 0, 8)
