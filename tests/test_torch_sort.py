"""tpu_qe_torch.sort against tpu_qe.sort and the C++ oracle, on CPU tensors
(the radix backend's kernels run as their plain twins here). Inputs come
from numpy seeds; the tolerance is exact equality of keys and payloads."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_qe.bits import U64 as JU64  # noqa: E402
from tpu_qe.sort import sort_u64 as jax_sort_u64  # noqa: E402
from tpu_qe.sort import sort_u64_numpy as jax_sort_numpy  # noqa: E402
from tpu_qe_torch import native  # noqa: E402
from tpu_qe_torch.bits import U64  # noqa: E402
from tpu_qe_torch.config import SortConfig  # noqa: E402
from tpu_qe_torch.sort import sort_u64, sort_u64_numpy  # noqa: E402
from tpu_qe_torch.sort.driver import signed_key  # noqa: E402


def _keys(n, seed=0, bits=64):
    return np.random.default_rng(seed).integers(0, 1 << bits, size=n,
                                                dtype=np.uint64)


@pytest.mark.parametrize("backend", ["radix", "torch", "torch_tiebreak"])
@pytest.mark.parametrize("n", [1, 255, 256, 1023, 1024, 1025, 3000])
def test_full_u64_sort_matches_stable_argsort(backend, n):
    keys = _keys(n, seed=n)
    payload = np.arange(n, dtype=np.uint32)
    k, p = sort_u64_numpy(keys, payload, backend=backend, block=1024)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(k, keys[order])
    np.testing.assert_array_equal(p, order.astype(np.uint32))


@pytest.mark.parametrize("n", [1, 1025, 3000])
def test_radix_matches_jax_hybrid(n):
    # the JAX radix dataflow (Pallas kernels in interpret mode, block 1024)
    keys = _keys(n, seed=100 + n)
    payload = np.arange(n, dtype=np.uint32)
    jk, jp = jax_sort_numpy(keys, payload, backend="hybrid", block=1024)
    k, p = sort_u64_numpy(keys, payload, backend="radix", block=1024)
    np.testing.assert_array_equal(k, jk)
    np.testing.assert_array_equal(p, jp)


@pytest.mark.parametrize("backend", ["radix", "torch"])
@pytest.mark.parametrize("key_bits,bpp", [(64, 8), (48, 8), (32, 8), (16, 8),
                                          (64, 6), (24, 6), (20, 4)])
def test_key_bits_match_jax_xla(backend, key_bits, bpp):
    keys = _keys(3000, seed=key_bits * 10 + bpp)
    payload = np.arange(3000, dtype=np.uint32)
    jk, jp = jax_sort_numpy(keys, payload, backend="xla", key_bits=key_bits)
    k, p = sort_u64_numpy(keys, payload, backend=backend, key_bits=key_bits,
                          bits_per_pass=bpp, block=512)
    np.testing.assert_array_equal(k, jk)       # high bits kept
    np.testing.assert_array_equal(p, jp)


@pytest.mark.parametrize("bpp,passes", [(8, 8), (6, 11)])
def test_matches_cpp_oracle(bpp, passes):
    keys = _keys(3000, seed=7)
    payload = np.arange(3000, dtype=np.uint32)
    ok, op = native.lsd_sort(keys, payload)
    cfg = SortConfig(bits_per_pass=bpp, num_passes=passes)
    k, p = sort_u64_numpy(keys, payload, bits_per_pass=bpp,
                          key_bits=cfg.key_bits)
    np.testing.assert_array_equal(k, ok)
    np.testing.assert_array_equal(p, op)


@pytest.mark.parametrize("backend", ["radix", "torch", "torch_tiebreak"])
def test_duplicate_heavy_keys_stay_stable(backend):
    keys = _keys(4000, seed=11, bits=2)
    payload = np.arange(4000, dtype=np.uint32)
    k, p = sort_u64_numpy(keys, payload, backend=backend, block=1024)
    np.testing.assert_array_equal(p, np.argsort(keys, kind="stable"))


def test_multiple_payload_columns_match_jax():
    keys = _keys(2000, seed=2)
    p1 = np.arange(2000, dtype=np.uint32)
    p2 = ((np.arange(2000, dtype=np.uint32) * 7) % 2000).astype(np.uint32)
    f3 = np.random.default_rng(3).standard_normal(2000).astype(np.float32)
    jk, (j1, j2, j3) = jax_sort_u64(JU64.from_numpy(keys), jnp.asarray(p1),
                                    jnp.asarray(p2), jnp.asarray(f3),
                                    backend="xla")
    tk, (t1, t2, t3) = sort_u64(U64.from_numpy(keys, "cpu"),
                                torch.from_numpy(p1.view(np.int32)),
                                torch.from_numpy(p2.view(np.int32)),
                                torch.from_numpy(f3), block=1024)
    np.testing.assert_array_equal(tk.to_numpy(), jk.to_numpy())
    np.testing.assert_array_equal(t1.numpy().view(np.uint32), np.asarray(j1))
    np.testing.assert_array_equal(t2.numpy().view(np.uint32), np.asarray(j2))
    np.testing.assert_array_equal(t3.numpy().view(np.float32), np.asarray(j3))


def test_inputs_are_not_modified():
    keys = _keys(3000, seed=4)
    k = U64.from_numpy(keys, "cpu")
    pay = torch.arange(3000, dtype=torch.int32)
    sort_u64(k, pay, block=1024)
    np.testing.assert_array_equal(k.to_numpy(), keys)
    assert torch.equal(pay, torch.arange(3000, dtype=torch.int32))


def test_signed_key_orders_like_unsigned():
    keys = np.array([0, 1, 0xFFFFFFFF, 1 << 32, (1 << 63) - 1, 1 << 63,
                     (1 << 64) - 1], dtype=np.uint64)
    k = U64.from_numpy(keys, "cpu")
    s = signed_key(k.lo, k.hi)
    assert bool((s[1:] > s[:-1]).all())
    np.testing.assert_array_equal(
        s.numpy().view(np.uint64) ^ np.uint64(1 << 63), keys)


def test_unstable_torch_backend_sorts_keys():
    keys = _keys(3000, seed=5, bits=8)
    k = sort_u64_numpy(keys, backend="torch", stable=False)
    np.testing.assert_array_equal(k, np.sort(keys))


def test_unknown_backend_raises():
    with pytest.raises(ValueError):
        sort_u64_numpy(_keys(10), backend="xla")


@pytest.mark.parametrize("key_bits", [64, 24])
@pytest.mark.parametrize("payload_kind", ["arange", "permutation"])
def test_tiebreak_matches_jax_xla_tiebreak(payload_kind, key_bits):
    n = 3000
    keys = _keys(n, seed=21, bits=10)                 # heavy key ties
    rng = np.random.default_rng(22)
    p1 = (np.arange(n, dtype=np.uint32) if payload_kind == "arange"
          else rng.permutation(n).astype(np.uint32) * np.uint32(2654435761))
    p2 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    tk, (t1, t2) = sort_u64(U64.from_numpy(keys, "cpu"),
                            torch.from_numpy(p1.view(np.int32)),
                            torch.from_numpy(p2.view(np.int32)),
                            backend="torch_tiebreak", key_bits=key_bits)
    order = np.argsort(keys & np.uint64((1 << key_bits) - 1)
                       if key_bits < 64 else keys, kind="stable")
    # stable by key for any payload
    np.testing.assert_array_equal(tk.to_numpy(), keys[order])
    np.testing.assert_array_equal(t1.numpy().view(np.uint32), p1[order])
    np.testing.assert_array_equal(t2.numpy().view(np.uint32), p2[order])
    if payload_kind == "arange":
        # the payload the JAX backend is meant for: its (key, payload)
        # order is the same
        jk, (j1, j2) = jax_sort_u64(JU64.from_numpy(keys), jnp.asarray(p1),
                                    jnp.asarray(p2), backend="xla_tiebreak",
                                    key_bits=key_bits)
        np.testing.assert_array_equal(tk.to_numpy(), jk.to_numpy())
        np.testing.assert_array_equal(t1.numpy().view(np.uint32),
                                      np.asarray(j1))
        np.testing.assert_array_equal(t2.numpy().view(np.uint32),
                                      np.asarray(j2))


def test_tiebreak_is_stable_with_stable_false():
    keys = _keys(3000, seed=12, bits=3)
    payload = np.arange(3000, dtype=np.uint32)
    k, p = sort_u64_numpy(keys, payload, backend="torch_tiebreak",
                          stable=False)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(k, keys[order])
    np.testing.assert_array_equal(p, order)


def test_tiebreak_takes_no_payload():
    keys = _keys(100, seed=1)
    np.testing.assert_array_equal(
        sort_u64_numpy(keys, backend="torch_tiebreak"), np.sort(keys))
