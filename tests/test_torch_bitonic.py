"""B5 (tpu_qe_torch.kernels.bitonic) on CPU tensors against the JAX Pallas
kernel tpu_qe.kernels.bitonic.sort_chunks in interpret mode, as
tests/test_bitonic.py runs it. Keys and payloads must be bit-identical,
including the order of payloads on tied keys, which tells the network's
per-pair rule apart from a textbook compare-exchange. Inputs come from
numpy seeds; tolerance: exact equality.

The CUDA kernel is held against this twin on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_qe.kernels.bitonic import sort_chunks as jax_sort_chunks  # noqa: E402
from tpu_qe_torch.kernels import LAUNCHES  # noqa: E402
from tpu_qe_torch.kernels import bitonic as bk  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(
        np.int32))


def _planes(rows, nb, n_pay, ties, seed):
    rng = np.random.default_rng(seed)
    shape = (nb, rows * 128)
    if ties:
        lo = rng.integers(0, 4, shape, dtype=np.uint32)
        hi = rng.integers(0, 2, shape, dtype=np.uint32)
    else:
        lo = rng.integers(0, 1 << 32, shape, dtype=np.uint32)
        hi = rng.integers(0, 1 << 32, shape, dtype=np.uint32)
    pays = [np.arange(nb * rows * 128, dtype=np.uint32).reshape(shape)]
    pays += [rng.integers(0, 1 << 32, shape, dtype=np.uint32)
             for _ in range(n_pay - 1)]
    return [lo, hi] + pays[:n_pay]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("rows,nb", [(8, 3), (16, 2), (64, 1)])
def test_twin_matches_pallas_keys_and_payloads(rows, nb, ties):
    planes = _planes(rows, nb, 1, ties, rows + ties)
    want = jax_sort_chunks(*planes, rows=rows)
    got = bk.sort_chunks(*[_t(p) for p in planes], rows=rows)
    _assert_same(got, want)


@pytest.mark.parametrize("n_pay", [0, 3])
def test_twin_matches_pallas_with_other_payload_counts(n_pay):
    planes = _planes(8, 2, n_pay, True, 40 + n_pay)
    want = jax_sort_chunks(*planes, rows=8)
    got = bk.sort_chunks(*[_t(p) for p in planes], rows=8)
    _assert_same(got, want)


# The shapes the CUDA kernel finds hard: chunks narrower than its tile of
# 8192 elements (several chunks share a CUDA block), no payload and the most
# payloads (which follow an index that is sorted with the keys), an odd
# number of chunks, all keys equal, and chunks already in or against order.

def _ordered_planes(rows, nb, n_pay, kind, seed):
    planes = _planes(rows, nb, n_pay, False, seed)
    width = rows * 128
    if kind == "all_equal":
        planes[0][:] = 7
        planes[1][:] = 3
    else:
        key = np.sort(planes[0].astype(np.uint64)
                      | (planes[1].astype(np.uint64) << np.uint64(32)), axis=1)
        if kind == "reversed":
            key = key[:, ::-1]
        planes[0] = (key & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        planes[1] = (key >> np.uint64(32)).astype(np.uint32)
    assert planes[0].shape == (nb, width)
    return planes


@pytest.mark.parametrize("n_pay", [0, 8])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("rows,nb", [(1, 5), (2, 3), (4, 1)])
def test_twin_matches_pallas_on_narrow_chunks(rows, nb, ties, n_pay):
    planes = _planes(rows, nb, n_pay, ties, 7 * rows + n_pay + ties)
    want = jax_sort_chunks(*planes, rows=rows)
    got = bk.sort_chunks(*[_t(p) for p in planes], rows=rows)
    _assert_same(got, want)


@pytest.mark.parametrize("kind", ["all_equal", "sorted", "reversed"])
@pytest.mark.parametrize("rows,nb", [(1, 3), (4, 2)])
def test_twin_matches_pallas_on_ordered_and_equal_chunks(rows, nb, kind):
    planes = _ordered_planes(rows, nb, 2, kind, rows)
    want = jax_sort_chunks(*planes, rows=rows)
    got = bk.sort_chunks(*[_t(p) for p in planes], rows=rows)
    _assert_same(got, want)
    if kind == "sorted":     # a sorted chunk with distinct keys stays put
        _assert_same(got[:2], planes[:2])


def test_tie_rule_is_the_networks_not_a_textbook_swap():
    # all keys equal: the JAX network still permutes the payload (equal keys
    # exchange in descending regions); a swap-if-greater network would
    # leave it in place
    zeros = np.zeros((1, 1024), dtype=np.uint32)
    pay = np.arange(1024, dtype=np.uint32)[None, :]
    want = jax_sort_chunks(zeros, zeros, pay, rows=8)
    got = bk.sort_chunks(_t(zeros), _t(zeros), _t(pay), rows=8)
    _assert_same(got, want)
    assert not np.array_equal(got[2].numpy(), pay)


def test_extreme_keys_sort_last():
    lo = np.zeros((1, 1024), dtype=np.uint32)
    hi = np.zeros((1, 1024), dtype=np.uint32)
    lo[0, :512] = 0xFFFFFFFF
    hi[0, :256] = 0xFFFFFFFF
    got = bk.sort_chunks(_t(lo), _t(hi), rows=8)
    want = jax_sort_chunks(lo, hi, rows=8)
    _assert_same(got, want)
    key = (got[0].numpy().view(np.uint32).astype(np.uint64)
           | (got[1].numpy().view(np.uint32).astype(np.uint64) << 32))
    ref = lo.astype(np.uint64) | (hi.astype(np.uint64) << 32)
    np.testing.assert_array_equal(key, np.sort(ref, axis=1))


def test_inputs_are_not_modified_and_no_kernel_runs():
    planes = [_t(p) for p in _planes(8, 2, 2, False, 3)]
    copies = [p.clone() for p in planes]
    before = dict(LAUNCHES)
    bk.sort_chunks(*planes, rows=8)
    assert LAUNCHES == before
    for p, c in zip(planes, copies):
        assert torch.equal(p, c)


def test_bad_arguments_raise():
    lo = torch.zeros((2, 1024), dtype=torch.int32)
    with pytest.raises(ValueError):
        bk.sort_chunks(lo, lo, rows=4)                  # width != rows * 128
    odd = torch.zeros((2, 384), dtype=torch.int32)
    with pytest.raises(ValueError):
        bk.sort_chunks(odd, odd, rows=3)                # not a power of two
    with pytest.raises(ValueError):
        bk.sort_chunks(lo, lo, *[lo] * 9, rows=8)       # 9 payloads
    with pytest.raises(ValueError):
        bk.sort_chunks(lo, lo[:1], rows=8)              # shapes differ
    with pytest.raises(ValueError):
        bk.sort_chunks(lo.reshape(-1), lo.reshape(-1), rows=16)
