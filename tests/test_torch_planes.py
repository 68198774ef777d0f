"""tpu_qe_torch.sort.planes (the port's counterpart of lax.sort with
num_keys) and bits.sortable_u32 against the JAX package and numpy, on CPU
tensors: the radix backend runs the kernels' plain twins here, at 8-bit
and at 9..16-bit digits. Tolerance: exact equality of every plane.

lax.sort with is_stable=True is the reference order (the port's sort is
stable); numpy's lexsort is a second, independent one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_qe import bits as jbits  # noqa: E402
from tpu_qe_torch import bits, native  # noqa: E402
from tpu_qe_torch.bits import U64  # noqa: E402
from tpu_qe_torch.kernels import histogram as hk  # noqa: E402
from tpu_qe_torch.kernels import scan as sk  # noqa: E402
from tpu_qe_torch.sort import driver  # noqa: E402
from tpu_qe_torch.sort import planes as sp  # noqa: E402


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint32)
                            .view(np.int32))


def _np(t):
    return t.numpy().view(np.uint32)


def _planes(rng, n, k, style):
    out = []
    for i in range(k):
        if style == "random":
            p = rng.integers(0, 1 << 32, n, dtype=np.uint64)
        elif style == "ties":
            p = rng.integers(0, 3, n, dtype=np.uint64) << np.uint64(30)
        else:                                   # all equal
            p = np.full(n, 0x80000001, dtype=np.uint64)
        out.append(p.astype(np.uint32))
    return out


def _reference(planes, num_keys):
    res = jax.lax.sort([jnp.asarray(p) for p in planes], num_keys=num_keys,
                       is_stable=True)
    return [np.asarray(r) for r in res]


@pytest.mark.parametrize("backend", ["radix", "torch"])
@pytest.mark.parametrize("style", ["random", "ties", "equal"])
@pytest.mark.parametrize("num_keys", [1, 2, 3, 4, 5, 6])
def test_sort_planes_matches_lax_sort(num_keys, style, backend):
    rng = np.random.default_rng(num_keys * 7 + len(style))
    n = 9000                                    # two blocks and a ragged one
    planes = _planes(rng, n, num_keys, style)
    planes.append(np.arange(n, dtype=np.uint32)[::-1].copy())   # payload
    got = sp.sort_planes([_t(p) for p in planes], num_keys, backend=backend)
    want = _reference(planes, num_keys)
    order = np.lexsort(planes[:num_keys][::-1])
    for g, w, p in zip(got, want, planes):
        np.testing.assert_array_equal(_np(g), w)
        np.testing.assert_array_equal(_np(g), p[order])


@pytest.mark.parametrize("backend", ["radix", "torch"])
@pytest.mark.parametrize("key_bits", [[1, 32, 32], [2, 32], [1], [3, 17, 32],
                                      [32, 5, 1, 32], [16, 16, 16]])
def test_key_bits_order_by_the_low_bits(key_bits, backend):
    rng = np.random.default_rng(sum(key_bits))
    n = 9000
    planes = [rng.integers(0, 1 << b, n, dtype=np.uint64).astype(np.uint32)
              for b in key_bits]
    planes.append(rng.integers(0, 1 << 32, n, dtype=np.uint64)
                  .astype(np.uint32))
    got = sp.sort_planes([_t(p) for p in planes], len(key_bits), key_bits,
                         backend=backend)
    for g, w in zip(got, _reference(planes, len(key_bits))):
        np.testing.assert_array_equal(_np(g), w)


def test_schedule_pairs_planes_and_counts_passes():
    groups = sp.schedule(3, [1, 32, 32])
    assert [(g.lo, g.hi) for g in groups] == [(2, 1), (0, None)]
    assert groups[1].digits == [(0, 1)]
    assert sp.num_passes(3, [1, 32, 32]) == 9
    assert sp.num_passes(2) == 8
    assert sp.num_passes(3, [32, 32, 2]) == 9
    assert sp.num_passes(2, [5, 3]) == 2          # (0, 3), (32, 5)
    # a full lo plane runs its digits on into the hi plane
    assert sp.schedule(2, [12, 32])[0].digits == [
        (0, 8), (8, 8), (16, 8), (24, 8), (32, 8), (40, 4)]
    assert sp.schedule(2, [32, 12])[0].digits == [
        (0, 8), (8, 4), (32, 8), (40, 8), (48, 8), (56, 8)]
    with pytest.raises(ValueError):
        sp.schedule(2, [0, 32])
    with pytest.raises(ValueError):
        sp.schedule(2, [32])


@pytest.mark.parametrize("bits_per_pass", [11, 16])
def test_wide_digit_passes_match_lax_sort(bits_per_pass):
    # the LSD driver that sort_planes and sort_u64 share, at wide digits
    rng = np.random.default_rng(bits_per_pass)
    hi, lo = _planes(rng, 9000, 2, "random")
    pay = np.arange(9000, dtype=np.uint32)
    digits = bits.digit_schedule(64, bits_per_pass)
    planes = [_t(lo), _t(hi), _t(pay)]
    slo, shi, (spay,) = driver.sort_radix(planes, digits)
    assert planes == []                 # handed over to the passes
    for g, w in zip((shi, slo, spay), _reference([hi, lo, pay], 2)):
        np.testing.assert_array_equal(_np(g), w)


def test_empty_and_single_row_and_bad_arguments():
    for n in (0, 1):
        ps = [_t(np.full(n, 5, np.uint32)), _t(np.arange(n, dtype=np.uint32))]
        for backend in ("radix", "torch"):
            out = sp.sort_planes(ps, 1, backend=backend)
            assert [o.shape[0] for o in out] == [n, n]
    p = _t(np.zeros(4, np.uint32))
    with pytest.raises(ValueError):
        sp.sort_planes([p], 2)
    with pytest.raises(ValueError):
        sp.sort_planes([p], 1, backend="xla")
    with pytest.raises(ValueError):
        sp.argsort_planes([p.to(torch.int64)])


@pytest.mark.parametrize("shift,bits", [(0, 11), (22, 11), (53, 11),
                                        (0, 16), (16, 16), (48, 16),
                                        (25, 9), (30, 13)])
@pytest.mark.parametrize("n", [1, 4097, 10_007])
def test_wide_digit_twins_match_the_cpp_oracles(shift, bits, n):
    # the plain twins the CUDA wide-digit kernels are held against
    keys = np.random.default_rng(n + shift).integers(0, 1 << 64, n,
                                                     dtype=np.uint64)
    block = 4096
    k = U64.from_numpy(keys, "cpu")
    hist = hk.block_histogram(k.lo, k.hi, shift, bits, block)
    radix, nb = 1 << bits, -(-n // block)
    if shift % bits == 0:
        np.testing.assert_array_equal(
            _np(hist), native.digit_major_histogram(keys, shift // bits, bits,
                                                    block))
    d = ((keys >> np.uint64(shift)) & np.uint64(radix - 1)).astype(np.int64)
    blk = np.arange(n, dtype=np.int64) // block
    ranks, hist2 = hk.block_rank_and_histogram(k.lo, k.hi, shift, bits, block)
    np.testing.assert_array_equal(
        _np(ranks), native.block_rank((blk * radix + d).astype(np.uint32),
                                      nb * radix))
    np.testing.assert_array_equal(_np(hist2), _np(hist))
    base = sk.exclusive_scan(hist.reshape(-1))
    olo, ohi, (opay,) = hk.rank_and_scatter(
        k.lo, k.hi, [_t(np.arange(n, dtype=np.uint32))], base, shift, bits,
        block)
    order = np.argsort(d, kind="stable")
    np.testing.assert_array_equal(U64(olo, ohi).to_numpy(), keys[order])
    np.testing.assert_array_equal(_np(opay), order)


def test_wide_digit_kernel_arguments_are_checked_before_launch():
    k = U64.from_numpy(np.arange(10, dtype=np.uint64), "cpu")
    assert hk.MAX_KERNEL_BITS == 16
    with pytest.raises(ValueError):
        hk._check_kernel_args(10, 1 << 16, 0, 9)     # u16 counters
    with pytest.raises(ValueError):
        hk._check_kernel_args(10, 4096, 0, 17)
    assert hk._check_kernel_args(10, 65535, 48, 16) == 1
    assert hk._check_kernel_args(10, 1 << 20, 0, 8) == 1
    hk.block_histogram(k.lo, k.hi, 0, 16)          # the twin takes 16 bits


@pytest.mark.parametrize("dtype", ["float32", "int32", "uint32"])
def test_sortable_u32_matches_jax_and_inverts(dtype):
    rng = np.random.default_rng(3)
    if dtype == "float32":
        x = rng.standard_normal(1000).astype(np.float32)
        x[:6] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45]
    else:
        x = rng.integers(0, 1 << 32, 1000, dtype=np.uint64).astype(
            np.uint32).view(dtype)
        x[:2] = np.array([0, 0xFFFFFFFF], np.uint32).view(dtype)
    t = torch.from_numpy(x.view(np.int32)).view(getattr(torch, dtype)) \
        if dtype == "uint32" else torch.from_numpy(x)
    b = bits.sortable_u32(t)
    want = np.asarray(jbits.sortable_u32(jnp.asarray(x)))
    np.testing.assert_array_equal(_np(b), want.view(np.uint32))
    back = bits.sortable_u32_inverse(b, t.dtype)
    np.testing.assert_array_equal(back.view(torch.int32).numpy(),
                                  t.view(torch.int32).numpy())
