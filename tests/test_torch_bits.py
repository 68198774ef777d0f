"""tpu_qe_torch.bits against tpu_qe.bits: same inputs (numpy seeds), same
bits. Every comparison is integer, so the tolerance is exact equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_qe import bits as jbits  # noqa: E402
from tpu_qe_torch import bits as tbits  # noqa: E402

BOUNDARY = np.array([0, 1, 0xFFFFFFFF, 1 << 32, (1 << 32) + 1, 1 << 63,
                     (1 << 63) - 1, (1 << 64) - 1, 0x8000000080000000,
                     0x00000000_C0000000, 0x3FFFFFFF_FFFFFFFF],
                    dtype=np.uint64)


def _keys(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([BOUNDARY,
                           rng.integers(0, 1 << 64, n, dtype=np.uint64)])


def _planes(keys):
    j = jbits.U64.from_numpy(keys)
    return j, tbits.U64.from_numpy(keys, "cpu")


def _u32(t):
    return t.numpy().view(np.uint32)


def test_u64_round_trip_and_layout():
    keys = _keys()
    j, t = _planes(keys)
    assert t.lo.dtype == torch.int32 and t.hi.dtype == torch.int32
    np.testing.assert_array_equal(t.to_numpy(), keys)
    np.testing.assert_array_equal(_u32(t.lo), np.asarray(j.lo))
    np.testing.assert_array_equal(_u32(t.hi), np.asarray(j.hi))


@pytest.mark.parametrize("shift,bits", [(0, 8), (8, 8), (24, 8), (28, 8),
                                        (32, 8), (56, 8), (0, 6), (30, 6),
                                        (60, 4), (31, 2), (20, 16), (48, 16)])
def test_select_digit_matches_jax(shift, bits):
    keys = _keys(seed=shift * 17 + bits)
    j, t = _planes(keys)
    want = np.asarray(jbits.select_digit(j.lo, j.hi, shift, bits))
    got = tbits.select_digit(t.lo, t.hi, shift, bits)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(
        got.numpy(), ((keys >> np.uint64(shift))
                      & np.uint64((1 << bits) - 1)).astype(np.int64))


@pytest.mark.parametrize("shift,bits", [(0, 0), (60, 8), (-1, 4), (0, 17)])
def test_select_digit_rejects_bad_digits(shift, bits):
    t = tbits.U64.from_numpy(_keys(4), "cpu")
    with pytest.raises(ValueError):
        tbits.select_digit(t.lo, t.hi, shift, bits)


@pytest.mark.parametrize("key_bits,bpp", [(64, 8), (64, 6), (48, 8),
                                          (32, 8), (16, 6), (66, 6), (1, 8)])
def test_digit_schedule_matches_jax(key_bits, bpp):
    assert (tbits.digit_schedule(key_bits, bpp)
            == jbits.digit_schedule(key_bits, bpp))


@pytest.mark.parametrize("key_bits", [1, 16, 31, 32, 33, 48, 63, 64])
def test_masked_key_matches_jax(key_bits):
    keys = _keys(seed=key_bits)
    j, t = _planes(keys)
    jm = jbits.masked_key(j.lo, j.hi, key_bits)
    tm = tbits.masked_key(t.lo, t.hi, key_bits)
    np.testing.assert_array_equal(_u32(tm.lo), np.asarray(jm.lo))
    np.testing.assert_array_equal(_u32(tm.hi), np.asarray(jm.hi))


@pytest.mark.parametrize("case", ["sorted", "unsorted", "equal_hi", "one",
                                  "empty"])
def test_is_sorted_matches_jax(case):
    keys = np.sort(_keys(seed=3))
    if case == "unsorted":
        keys = keys.copy()
        keys[[5, 900]] = keys[[900, 5]]
    elif case == "equal_hi":
        keys = (np.uint64(0xDEADBEEF) << np.uint64(32)) | np.array(
            [3, 2, 7], dtype=np.uint64)
    elif case == "one":
        keys = keys[:1]
    elif case == "empty":
        keys = keys[:0]
    j, t = _planes(keys)
    assert (bool(tbits.is_sorted_u64(t.lo, t.hi))
            == bool(jbits.is_sorted_u64(j.lo, j.hi)))


def test_pack_columns_bit_patterns():
    rng = np.random.default_rng(1)
    f = rng.standard_normal(50).astype(np.float32)
    i = rng.integers(-(1 << 31), 1 << 31, 50, dtype=np.int64).astype(np.int32)
    u = rng.integers(0, 1 << 32, 50, dtype=np.uint64).astype(np.uint32)
    want = jbits.pack_columns([jnp.asarray(f), jnp.asarray(i), jnp.asarray(u)])
    got = tbits.pack_columns([torch.from_numpy(f), torch.from_numpy(i),
                              torch.from_numpy(u.view(np.int32)).view(
                                  torch.uint32)])
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(_u32(g), np.asarray(w))
    with pytest.raises(TypeError):
        tbits.pack_columns([torch.zeros(3, dtype=torch.int64)])


def test_widen_narrow_round_trip():
    u = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], dtype=np.uint32)
    t = torch.from_numpy(u.view(np.int32))
    w = tbits.widen(t)
    np.testing.assert_array_equal(w.numpy(), u.astype(np.int64))
    assert torch.equal(tbits.narrow(w), t)
    assert torch.equal(tbits.narrow(w + (1 << 32)), t)   # mod 2^32
