"""tpu_qe_torch.ops.segscan and the segmented reductions of
ops/aggregate.py against the JAX package, on CPU tensors. Inputs come from
numpy seeds, with bit-31 values. Integer and flag results: exact equality.
Float32 segmented sums: exact equality too, since the port folds in the
JAX package's blocked order (BLOCK = 1024); the sizes cover the flat path
(n <= 4096) and the blocked one, with a ragged last block.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_qe.ops import aggregate as jagg  # noqa: E402
from tpu_qe.ops import segscan as jseg  # noqa: E402
from tpu_qe_torch.ops import aggregate as tagg  # noqa: E402
from tpu_qe_torch.ops import segscan as tseg  # noqa: E402

SIZES = [1, 100, 4096, 4097, 20_000]


def _u32(n, seed):
    x = np.random.default_rng(seed).integers(0, 1 << 32, n, dtype=np.uint64)
    return x.astype(np.uint32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _np(t):
    return t.numpy().view(np.uint32)


def _flags(n, seed, p=0.05):
    f = np.random.default_rng(seed).random(n) < p
    f[0] = True
    return f


@pytest.mark.parametrize("n", SIZES)
def test_integer_wrappers_match_jax(n):
    v = _u32(n, n)
    np.testing.assert_array_equal(_np(tseg.cumsum_u32(_t(v))),
                                  np.asarray(jseg.cumsum_u32(jnp.asarray(v))))
    np.testing.assert_array_equal(_np(tseg.cummax_u32(_t(v))),
                                  np.asarray(jseg.cummax_u32(jnp.asarray(v))))
    lo, hi = tseg.cumsum_u64_pair(_t(v))
    jlo, jhi = jseg.cumsum_u64_pair(jnp.asarray(v))
    np.testing.assert_array_equal(_np(lo), np.asarray(jlo))
    np.testing.assert_array_equal(_np(hi), np.asarray(jhi))
    exact = np.cumsum(v.astype(np.uint64))
    np.testing.assert_array_equal(
        _np(lo).astype(np.uint64) | (_np(hi).astype(np.uint64) << 32), exact)


@pytest.mark.parametrize("n", SIZES)
def test_signed_pair_sum_matches_jax(n):
    v = _u32(n, n + 1).view(np.int32)
    vhi = np.where(v < 0, np.uint32(0xFFFFFFFF), np.uint32(0))
    lo, hi = tseg.cumsum_u64_pair(torch.from_numpy(v), _t(vhi))
    jlo, jhi = jseg.cumsum_u64_pair(jnp.asarray(v).view(jnp.uint32),
                                    jnp.asarray(vhi))
    np.testing.assert_array_equal(_np(lo), np.asarray(jlo))
    np.testing.assert_array_equal(_np(hi), np.asarray(jhi))


@pytest.mark.parametrize("n", SIZES)
def test_scan_assoc_generic_monoid_matches_jax(n):
    # (max, count) tuple monoid with a don't-care-free combine
    a, b = _u32(n, 5) >> np.uint32(4), _u32(n, 6) >> np.uint32(20)

    def tcomb(x, y):
        return (torch.maximum(x[0], y[0]), x[1] + y[1])

    def jcomb(x, y):
        return (jnp.maximum(x[0], y[0]), x[1] + y[1])

    got = tseg.scan_assoc(tcomb, (0, 0), (torch.from_numpy(a.astype(np.int64)),
                                          torch.from_numpy(b.astype(np.int64))))
    want = jseg.scan_assoc(jcomb, (0, 0), (jnp.asarray(a), jnp.asarray(b)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", ["float32", "uint32", "int32"])
@pytest.mark.parametrize("n", SIZES)
def test_segmented_reduce_matches_jax_bit_for_bit(n, dtype, kind):
    rng = np.random.default_rng(n + len(kind))
    if dtype == "float32":
        v = (rng.standard_normal(n) * 1e3).astype(np.float32)
        tv = torch.from_numpy(v)
    else:
        v = _u32(n, n + 7).view(dtype)
        tv = torch.from_numpy(v.view(np.int32))
        tv = tv.view(torch.uint32) if dtype == "uint32" else tv
    f = _flags(n, n)
    got = tagg.segmented_reduce(tv, torch.from_numpy(f), kind)
    want = np.asarray(jagg.segmented_reduce(jnp.asarray(v), jnp.asarray(f),
                                            kind))
    assert got.dtype == tv.dtype
    np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                  want.view(np.int32))


@pytest.mark.parametrize("n", SIZES)
def test_segmented_sum_u64_matches_jax(n):
    lo, hi = _u32(n, 1), _u32(n, 2) >> np.uint32(3)
    f = _flags(n, n + 3, 0.01)
    glo, ghi = tagg.segmented_sum_u64(_t(lo), _t(hi), torch.from_numpy(f))
    jlo, jhi = jagg.segmented_sum_u64(jnp.asarray(lo), jnp.asarray(hi),
                                      jnp.asarray(f))
    np.testing.assert_array_equal(_np(glo), np.asarray(jlo))
    np.testing.assert_array_equal(_np(ghi), np.asarray(jhi))
