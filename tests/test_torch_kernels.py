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


# ---- B3 at the shapes its CUDA kernel is held to on the card: blocks that
# are not multiples of its 4096-key tile, 0/3/8 payload planes, a lone plane
# passed as both words, a digit that straddles bit 32, a 1-bit digit, every
# key on one digit, heavy ties, and sizes around one tile.

B3_TILE = 4096
B3_BLOCKS = [1000, 4096, 5000, 65536]
B3_CASES = [("random", 0, 8), ("random", 28, 8), ("random", 7, 1),
            ("skewed", 24, 8), ("ties", 40, 8), ("lone", 0, 1),
            ("lone", 24, 8)]


def _b3_planes(n, kind, shift, bits, seed):
    """(keys, lo, hi) for one of B3's hard cases; a lone plane's key is
    lo | lo << 32 and hi is the very same tensor as lo."""
    keys = _keys(n, seed)
    mask = np.uint64(((1 << bits) - 1) << shift)
    if kind == "skewed":
        keys = (keys & ~mask) | ((np.uint64(0x5A5A) << np.uint64(shift)) & mask)
    elif kind == "ties":
        keys = keys & ~mask | (keys >> np.uint64(63) << np.uint64(shift))
    elif kind == "lone":
        keys = (keys & np.uint64(0xFFFFFFFF)) * np.uint64(0x100000001)
    k = U64.from_numpy(keys, "cpu")
    return keys, k.lo, k.lo if kind == "lone" else k.hi


def _digits(keys, shift, bits):
    return ((keys >> np.uint64(shift))
            & np.uint64((1 << bits) - 1)).astype(np.int64)


def _check_rank_plain(keys, lo, hi, shift, bits, block):
    n, radix = len(keys), 1 << bits
    nb = -(-n // block)
    ranks, hist = hk.block_rank_and_histogram(lo, hi, shift, bits,
                                              block=block)
    np.testing.assert_array_equal(_u32(ranks),
                                  _native_ranks(keys, shift, bits, block))
    b = np.arange(n, dtype=np.int64) // block
    want = np.bincount(_digits(keys, shift, bits) * nb + b,
                       minlength=radix * nb).reshape(radix, nb)
    np.testing.assert_array_equal(_u32(hist), want)
    return hist


def _check_scatter_plain(keys, lo, hi, shift, bits, block, n_pay):
    n = len(keys)
    hist = hk.block_histogram(lo, hi, shift, bits, block=block)
    base = sk.exclusive_scan(hist.reshape(-1))
    pays = [torch.from_numpy(((np.arange(n, dtype=np.int64) * (2 * i + 1) + i)
                              & 0x7FFFFFFF).astype(np.int32))
            for i in range(n_pay)]
    olo, ohi, opays = hk.rank_and_scatter(lo, hi, pays, base, shift, bits,
                                          block=block)
    order = np.argsort(_digits(keys, shift, bits), kind="stable")
    if shift % bits == 0:
        dest = native.scatter_locations(keys, shift // bits, bits, block)
        inverse = np.empty(n, dtype=np.int64)
        inverse[dest.astype(np.int64)] = np.arange(n)
        np.testing.assert_array_equal(inverse, order)
        np.testing.assert_array_equal(
            hk.scatter_destinations_plain(lo, hi, base, shift, bits,
                                          block=block).numpy(),
            dest.astype(np.int64))
    np.testing.assert_array_equal(U64(olo, ohi).to_numpy(), keys[order])
    assert len(opays) == n_pay
    for p, o in zip(pays, opays):
        np.testing.assert_array_equal(o.numpy(), p.numpy()[order])


@pytest.mark.parametrize("block", B3_BLOCKS)
@pytest.mark.parametrize("kind,shift,bits", B3_CASES)
def test_b3_rank_plain_matches_native(kind, shift, bits, block):
    keys, lo, hi = _b3_planes(70_777, kind, shift, bits, shift + block)
    _check_rank_plain(keys, lo, hi, shift, bits, block)


@pytest.mark.parametrize("n_pay", [0, 3, 8])
@pytest.mark.parametrize("block", B3_BLOCKS)
@pytest.mark.parametrize("kind,shift,bits", B3_CASES)
def test_b3_scatter_plain_matches_native(kind, shift, bits, block, n_pay):
    keys, lo, hi = _b3_planes(70_777, kind, shift, bits, shift + block + 1)
    _check_scatter_plain(keys, lo, hi, shift, bits, block, n_pay)


@pytest.mark.parametrize("n", [1, B3_TILE - 1, B3_TILE + 1, (1 << 22) + 777])
@pytest.mark.parametrize("block", B3_BLOCKS)
def test_b3_plain_at_ragged_sizes(block, n):
    keys, lo, hi = _b3_planes(n, "random", 24, 8, n + block)
    _check_rank_plain(keys, lo, hi, 24, 8, block)
    _check_scatter_plain(keys, lo, hi, 24, 8, block, 1)


@pytest.mark.parametrize("block", [4096, 65536])
@pytest.mark.parametrize("kind,shift,bits", [
    ("random", 28, 8), ("random", 7, 1), ("skewed", 24, 8), ("lone", 0, 1),
    ("lone", 24, 8)])
def test_b3_rank_plain_matches_jax(kind, shift, bits, block):
    # the JAX kernel takes whole blocks: pad with all-ones sentinels, which
    # for a lone plane are again lo == hi
    keys, _, _ = _b3_planes(70_777, kind, shift, bits, shift + block + 2)
    padded, jlo, jhi = _padded(keys, block)
    k = U64.from_numpy(padded, "cpu")
    ranks, hist = hk.block_rank_and_histogram(
        k.lo, k.lo if kind == "lone" else k.hi, shift, bits, block=block)
    jr, jh = jax_block_rank(jlo, jhi, shift, bits)
    np.testing.assert_array_equal(_u32(ranks), np.asarray(jr).reshape(-1))
    np.testing.assert_array_equal(_u32(hist), np.asarray(jh))


# ---- B2 at the shapes its single-pass CUDA kernel finds hard (tiles of
# 8192 words chained by look-back, 16-byte loads): sizes around a tile, no
# multiple of 4, a slice that starts 4 bytes into its tensor, words that
# wrap in every tile's aggregate, one large word then zeros. The reference
# is numpy's u64 cumsum mod 2^32 and the JAX kernel in interpret mode, which
# takes multiples of 1024: zeros appended to the input change no prefix.

B2_TILE = 8192
B2_SIZES = [0, 1, 3, 4095, 4096, 4097, B2_TILE - 1, B2_TILE, B2_TILE + 1,
            3 * B2_TILE + 3, 20_001]
B2_KINDS = ["random", "all_ones", "large_then_zeros"]


def _scan_input(kind, n, seed):
    if kind == "all_ones":
        return np.full(n, 0xFFFFFFFF, dtype=np.uint32)
    if kind == "large_then_zeros":
        x = np.zeros(n, dtype=np.uint32)
        x[:1] = 0xFFFFFFF0
        return x
    return np.random.default_rng(seed).integers(
        0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)


def _check_scan(x_np, x_t):
    got = _u32(sk.exclusive_scan(x_t))
    wide = x_np.astype(np.uint64)
    want = ((np.cumsum(wide) - wide) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    np.testing.assert_array_equal(got, want)
    padded = np.zeros(max(-(-len(x_np) // 1024), 1) * 1024, dtype=np.uint32)
    padded[:len(x_np)] = x_np
    np.testing.assert_array_equal(
        got, np.asarray(jax_exclusive_scan(padded))[:len(x_np)])


@pytest.mark.parametrize("n", B2_SIZES)
@pytest.mark.parametrize("kind", B2_KINDS)
def test_exclusive_scan_hard_shapes(kind, n):
    x = _scan_input(kind, n, n)
    _check_scan(x, torch.from_numpy(x.view(np.int32)))


@pytest.mark.parametrize("n", [1, B2_TILE, B2_TILE + 1, 20_001])
@pytest.mark.parametrize("kind", B2_KINDS)
def test_exclusive_scan_of_a_slice_four_bytes_into_its_tensor(kind, n):
    x = _scan_input(kind, n + 1, n + 1)
    t = torch.from_numpy(x.view(np.int32))[1:]
    assert t.is_contiguous() and t.data_ptr() % 16 == 4
    _check_scan(x[1:], t)


# ---- B3 at 9..16-bit digits at the shapes its CUDA scatter (a sort of the
# tile, then stores in digit order) and rank mode are held to on the card:
# every key on one digit, each key of a run of 2^bits keys on its own digit,
# a digit that straddles bit 32, 0 and 3 payloads, blocks of one tile, of a
# tile and a bit, and of many tiles, and sizes around one tile.

WIDE_BITS = [9, 11, 13, 16]
WIDE_BLOCKS = [4096, 5000, 32768, 65535]
WIDE_KINDS = ["one_digit", "own_digits", "straddling"]


def _wide_planes(n, kind, bits, seed):
    """(keys, lo, hi, shift) for one of the wide kernels' hard cases."""
    keys = _keys(n, seed)
    mask = np.uint64((1 << bits) - 1)
    shift = 0
    if kind == "one_digit":
        keys = (keys & ~mask) | (np.uint64(0x5A5A) & mask)
    elif kind == "own_digits":
        keys = (keys & ~mask) | (
            (np.arange(n, dtype=np.uint64) * np.uint64(40503)) & mask)
    else:
        shift = 32 - bits // 2
    k = U64.from_numpy(keys, "cpu")
    return keys, k.lo, k.hi, shift


@pytest.mark.parametrize("block", WIDE_BLOCKS)
@pytest.mark.parametrize("kind", WIDE_KINDS)
@pytest.mark.parametrize("bits", WIDE_BITS)
def test_wide_rank_plain_matches_native(bits, kind, block):
    keys, lo, hi, shift = _wide_planes(70_777, kind, bits, bits + block)
    _check_rank_plain(keys, lo, hi, shift, bits, block)


@pytest.mark.parametrize("n_pay", [0, 3])
@pytest.mark.parametrize("block", WIDE_BLOCKS)
@pytest.mark.parametrize("kind", WIDE_KINDS)
@pytest.mark.parametrize("bits", WIDE_BITS)
def test_wide_scatter_plain_is_one_stable_pass(bits, kind, block, n_pay):
    keys, lo, hi, shift = _wide_planes(70_777, kind, bits, bits + block + 1)
    _check_scatter_plain(keys, lo, hi, shift, bits, block, n_pay)


@pytest.mark.parametrize("n", [1, B3_TILE - 1, B3_TILE + 1])
@pytest.mark.parametrize("bits", WIDE_BITS)
def test_wide_plain_at_sizes_around_a_tile(bits, n):
    for block in (4096, 5000):
        keys, lo, hi, shift = _wide_planes(n, "straddling", bits, n + bits)
        _check_rank_plain(keys, lo, hi, shift, bits, block)
        _check_scatter_plain(keys, lo, hi, shift, bits, block, 1)


@pytest.mark.parametrize("kind", WIDE_KINDS)
@pytest.mark.parametrize("bits", [9, 11])
def test_wide_rank_plain_matches_jax(bits, kind):
    # the JAX kernel builds a (8, 128, radix) one-hot per step: 9 and 11
    # bits are what a CPU run can afford; it takes whole blocks, so pad
    # with all-ones sentinels
    keys, _, _, shift = _wide_planes(9_000, kind, bits, bits)
    padded, jlo, jhi = _padded(keys, 4096)
    k = U64.from_numpy(padded, "cpu")
    ranks, hist = hk.block_rank_and_histogram(k.lo, k.hi, shift, bits,
                                              block=4096)
    jr, jh = jax_block_rank(jlo, jhi, shift, bits)
    np.testing.assert_array_equal(_u32(ranks), np.asarray(jr).reshape(-1))
    np.testing.assert_array_equal(_u32(hist), np.asarray(jh))


# ---- B1 at 9..16-bit digits at the shapes its CUDA kernel (groups of eight
# key blocks counted into u16 counters per window of 4096 digits, stored as
# whole sectors) is held to on the card: blocks that are no multiple of
# anything, a block count that is odd or no multiple of the group, a block
# of 65535 keys on one digit (the largest u16 count), keys on two digits
# only (the rest of the table all zeros), a digit that straddles bit 32.

B1_WIDE_BLOCKS = [1000, 4096, 5000, 32768, 65535]
B1_WIDE_KINDS = WIDE_KINDS + ["two_digits"]


def _b1_wide_planes(n, kind, bits, seed):
    if kind != "two_digits":
        return _wide_planes(n, kind, bits, seed)
    keys = _keys(n, seed)
    mask = np.uint64((1 << bits) - 1)
    keys = (keys & ~mask) | np.where(keys >> np.uint64(63), mask,
                                      np.uint64(1))
    k = U64.from_numpy(keys, "cpu")
    return keys, k.lo, k.hi, 0


def _check_histogram_plain(keys, lo, hi, shift, bits, block):
    n, radix = len(keys), 1 << bits
    nb = -(-n // block)
    got = hk.block_histogram(lo, hi, shift, bits, block=block)
    assert got.shape == (radix, nb) and got.dtype == torch.int32
    b = np.arange(n, dtype=np.int64) // block
    want = np.bincount(_digits(keys, shift, bits) * nb + b,
                       minlength=radix * nb).reshape(radix, nb)
    np.testing.assert_array_equal(_u32(got), want)
    return got


@pytest.mark.parametrize("block", B1_WIDE_BLOCKS)
@pytest.mark.parametrize("kind", B1_WIDE_KINDS)
@pytest.mark.parametrize("bits", WIDE_BITS)
def test_wide_histogram_plain_matches_bincount(bits, kind, block):
    keys, lo, hi, shift = _b1_wide_planes(70_777, kind, bits, bits + block)
    hist = _check_histogram_plain(keys, lo, hi, shift, bits, block)
    if kind == "two_digits":
        h = _u32(hist)
        assert h[1].sum() + h[-1].sum() == 70_777
        assert not h[2:-1].any() and not h[0].any()


@pytest.mark.parametrize("n", [1, 4095, 4097, 65535])
@pytest.mark.parametrize("bits", WIDE_BITS)
def test_wide_histogram_plain_at_ragged_sizes(bits, n):
    for block in (1000, 4096, 65535):
        keys, lo, hi, shift = _b1_wide_planes(n, "straddling", bits, n + bits)
        _check_histogram_plain(keys, lo, hi, shift, bits, block)


@pytest.mark.parametrize("bits", WIDE_BITS)
def test_wide_histogram_plain_counts_a_whole_block_on_one_digit(bits):
    keys, lo, hi, shift = _b1_wide_planes(65535 + 10, "one_digit", bits, bits)
    hist = _u32(_check_histogram_plain(keys, lo, hi, shift, bits, 65535))
    np.testing.assert_array_equal(hist[0x5A5A & ((1 << bits) - 1)],
                                  [65535, 10])


@pytest.mark.parametrize("kind", B1_WIDE_KINDS)
@pytest.mark.parametrize("bits", [9, 11, 13])
def test_wide_histogram_plain_matches_jax(bits, kind):
    # the JAX kernel builds a (8, 128, radix) one-hot per step: up to 13
    # bits is what a CPU run can afford; it takes whole blocks of a multiple
    # of 1024 keys, so pad with all-ones sentinels
    keys, _, _, shift = _b1_wide_planes(9_000, kind, bits, bits + 1)
    padded, jlo, jhi = _padded(keys, 4096)
    k = U64.from_numpy(padded, "cpu")
    got = hk.block_histogram(k.lo, k.hi, shift, bits, block=4096)
    want = np.asarray(jax_block_histogram(jlo, jhi, shift, bits))
    np.testing.assert_array_equal(_u32(got), want)


def _stop_early_variants():
    from tpu_qe_torch.bench import stop_early
    return [(k, name) for k, (_, variants) in stop_early.SOURCES.items()
            for name in variants]


@pytest.mark.parametrize("kernel,name", _stop_early_variants())
def test_stop_early_variants_still_find_their_lines(tmp_path, monkeypatch,
                                                    kernel, name):
    # bench/stop_early.py times copies of the CUDA sources with lines
    # replaced; a line that left the source must fail here, not on the card
    import os
    import sys
    from tpu_qe_torch.bench import stop_early
    tree = stop_early.make_variant(str(tmp_path), kernel, name)
    source, variants = stop_early.SOURCES[kernel]
    with open(os.path.join(tree, "tpu_qe_torch", "csrc", source)) as f:
        text = f.read()
    with open(os.path.join(stop_early.PACKAGE, "csrc", source)) as f:
        assert (text == f.read()) == (not variants[name])
    # in this process the package is already imported from elsewhere
    monkeypatch.setattr(sys, "path", list(sys.path))
    with pytest.raises(RuntimeError, match="not the package of"):
        stop_early.time_variant(tree, kernel, 8192)


def test_radix_pass_script_refuses_a_tree_it_did_not_import(tmp_path):
    from tpu_qe_torch.bench import radix_pass
    with pytest.raises(RuntimeError, match="not that tree's"):
        radix_pass.main(["--tree", str(tmp_path), "--n", "100"])
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        radix_pass.main(["--n", "100"])
