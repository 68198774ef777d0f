"""tpu_qe_torch.hashing against tpu_qe.hashing and the numpy mirrors, on
CPU tensors. Inputs come from numpy seeds and include values with bit 31
set; the tolerance is exact equality (every certificate of the out-of-core
drivers depends on these bits)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_qe import hashing as jh  # noqa: E402
from tpu_qe_torch import hashing as th  # noqa: E402


def _u32(n, seed):
    x = np.random.default_rng(seed).integers(0, 1 << 32, n, dtype=np.uint64)
    x = x.astype(np.uint32)
    x[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]
    x[4:8] |= np.uint32(0x80000000)          # bit 31 set
    return x


def _t(x):
    return torch.from_numpy(x.view(np.int32))


@pytest.mark.parametrize("n", [8, 1000, 4099])
def test_murmur_fmix32_matches_jax_and_numpy(n):
    x = _u32(n, n)
    got = th.murmur_fmix32(_t(x)).numpy().view(np.uint32)
    np.testing.assert_array_equal(
        got, np.asarray(jh.murmur_fmix32(jnp.asarray(x))))
    np.testing.assert_array_equal(got, jh.murmur_fmix32_numpy(x))
    np.testing.assert_array_equal(th.murmur_fmix32_numpy(x), got)


@pytest.mark.parametrize("seed", [0, 7, 11, 0xFFFFFFFF])
@pytest.mark.parametrize("n", [8, 3001])
def test_keygen_hash_matches_jax_and_numpy(n, seed):
    idx = _u32(n, n + 1)
    got = th.keygen_hash(_t(idx), seed).to_numpy()
    np.testing.assert_array_equal(
        got, jh.keygen_hash(jnp.asarray(idx), seed).to_numpy())
    np.testing.assert_array_equal(got, jh.keygen_hash_numpy(idx, seed))
    np.testing.assert_array_equal(th.keygen_hash_numpy(idx, seed), got)


def test_keygen_hash_is_regenerable_from_the_payload():
    idx = np.arange(1 << 16, dtype=np.uint32)
    keys = th.keygen_hash(_t(idx))
    again = th.keygen_hash(_t(idx))
    assert torch.equal(keys.lo, again.lo) and torch.equal(keys.hi, again.hi)
    assert len(np.unique(keys.to_numpy())) == len(idx)   # bijective lo
