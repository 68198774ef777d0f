"""B6 (tpu_qe_torch.kernels.rank_mxu) on CPU tensors against the JAX Pallas
kernel tpu_qe.kernels.rank_mxu in interpret mode (as tests/test_sort.py
runs it), against the port's B3 twin, and against the C++ rank oracle.
Includes the skewed-digit regression that a low-precision prefix would
break, blocks whose one digit counts past 2048 (fp16's exact range) and
2^16, and ragged tails: n no multiple of the block, blocks no multiple of
the kernel's 32-key step. Inputs come from numpy seeds; tolerance: exact
equality.

The CUDA kernel is held against this twin on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_qe.kernels.rank_mxu import (  # noqa: E402
    block_rank_and_histogram_mxu as jax_mxu,
    nibble_hist_to_digit_major as jax_nibble)
from tpu_qe_torch import native  # noqa: E402
from tpu_qe_torch.bits import U64  # noqa: E402
from tpu_qe_torch.kernels import LAUNCHES  # noqa: E402
from tpu_qe_torch.kernels import histogram as hk  # noqa: E402
from tpu_qe_torch.kernels import rank_mxu as rk  # noqa: E402


def _u32(t):
    return t.numpy().view(np.uint32)


def _split(keys):
    return ((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (keys >> np.uint64(32)).astype(np.uint32))


@pytest.mark.parametrize("nb,block,shift", [(2, 1024, 0), (1, 2048, 24),
                                            (3, 1024, 56), (1, 1024, 28)])
def test_twin_matches_pallas(nb, block, shift):
    keys = np.random.default_rng(nb * 100 + shift).integers(
        0, 1 << 64, nb * block, dtype=np.uint64)
    lo, hi = _split(keys)
    jr, jh = jax_mxu(lo.reshape(nb, block), hi.reshape(nb, block), shift)
    k = U64.from_numpy(keys, "cpu")
    r, h = rk.block_rank_and_histogram_mxu(k.lo, k.hi, shift, block=block)
    np.testing.assert_array_equal(_u32(r), np.asarray(jr).reshape(-1))
    np.testing.assert_array_equal(_u32(h), np.asarray(jh))


@pytest.mark.parametrize("digits", ["zero_one", "single"])
def test_skewed_digits_regression_matches_pallas(digits):
    # the JAX regression: a bf16 prefix corrupted ranks once a digit's
    # running count passed 256
    rng = np.random.default_rng(5)
    lo = (rng.integers(0, 2, (1, 2048)).astype(np.uint32) if digits ==
          "zero_one" else np.full((1, 2048), 0x5A, dtype=np.uint32))
    hi = np.zeros((1, 2048), dtype=np.uint32)
    jr, jh = jax_mxu(lo, hi, 0)
    r, h = rk.block_rank_and_histogram_mxu(torch.from_numpy(
        lo.reshape(-1).view(np.int32)), torch.from_numpy(
        hi.reshape(-1).view(np.int32)), 0, block=2048)
    np.testing.assert_array_equal(_u32(r), np.asarray(jr).reshape(-1))
    np.testing.assert_array_equal(_u32(h), np.asarray(jh))
    assert _u32(r).max() >= 1000


@pytest.mark.parametrize("block", [1024, 4096, 1000, 100])
@pytest.mark.parametrize("n", [0, 1, 1023, 5000])
def test_twin_matches_b3_and_native_at_ragged_sizes(n, block):
    rng = np.random.default_rng(n + block)
    for keys in (rng.integers(0, 1 << 64, n, dtype=np.uint64),
                 rng.integers(0, 2, n, dtype=np.uint64)):
        k = U64.from_numpy(keys, "cpu")
        for shift in (0, 30):
            r, h = rk.block_rank_and_histogram_mxu(k.lo, k.hi, shift, block)
            r3, h3 = hk.block_rank_and_histogram(k.lo, k.hi, shift, 8, block)
            assert torch.equal(r, r3) and torch.equal(h, h3)
            d = ((keys >> np.uint64(shift)) & np.uint64(255)).astype(np.int64)
            b = np.arange(n, dtype=np.int64) // block
            nb = -(-n // block)
            np.testing.assert_array_equal(
                _u32(r), native.block_rank((b * 256 + d).astype(np.uint32),
                                           max(nb, 1) * 256))


def _oracle_ranks(keys, shift, block):
    d = ((keys >> np.uint64(shift)) & np.uint64(255)).astype(np.int64)
    b = np.arange(keys.shape[0], dtype=np.int64) // block
    return native.block_rank((b * 256 + d).astype(np.uint32),
                             max(-(-keys.shape[0] // block), 1) * 256)


@pytest.mark.parametrize("block", [1000, 4096, 8192, 65535, 1 << 17])
def test_one_digit_counts_past_fp16_and_2p16(block):
    # every key on one digit: a block's count of it reaches the block size
    n = 2 * block + 77
    keys = np.random.default_rng(block).integers(0, 1 << 64, n,
                                                 dtype=np.uint64)
    keys = (keys & ~np.uint64(0xFF << 8)) | np.uint64(0x5A << 8)
    k = U64.from_numpy(keys, "cpu")
    r, h = rk.block_rank_and_histogram_mxu(k.lo, k.hi, 8, block)
    r3, h3 = hk.block_rank_and_histogram_plain(k.lo, k.hi, 8, 8, block)
    assert torch.equal(r, r3) and torch.equal(h, h3)
    np.testing.assert_array_equal(_u32(r), _oracle_ranks(keys, 8, block))
    assert int(r.max()) == block - 1 and int(h[0x5A].max()) == block
    assert block <= 2048 or int(r.max()) >= 2048


@pytest.mark.parametrize("block,n", [(33, 1000), (1000, 4097), (4096, 4095),
                                     (8192, 9000), (65535, 70001)])
def test_ragged_tails_match_b3_and_native(block, n):
    rng = np.random.default_rng(block + n)
    for keys in (rng.integers(0, 1 << 64, n, dtype=np.uint64),
                 rng.integers(0, 2, n, dtype=np.uint64) << np.uint64(40)):
        k = U64.from_numpy(keys, "cpu")
        for shift in (0, 28, 40, 56):
            r, h = rk.block_rank_and_histogram_mxu(k.lo, k.hi, shift, block)
            r3, h3 = hk.block_rank_and_histogram_plain(k.lo, k.hi, shift, 8,
                                                       block)
            assert torch.equal(r, r3) and torch.equal(h, h3)
        np.testing.assert_array_equal(_u32(r), _oracle_ranks(keys, 56, block))


def test_step_algebra_on_one_step():
    # X X^T == 2 is digit equality; H is the step's nibble histogram
    rng = np.random.default_rng(3)
    d = torch.from_numpy(rng.integers(0, 256, (1, 1, 32)))
    d[0, 0, 31] = d[0, 0, 3]
    nh, nl = d >> 4, d & 15
    r, h = rk._rank_steps_plain(nh, nl)
    want = [int((d[0, 0, :i] == d[0, 0, i]).sum()) for i in range(32)]
    assert r[0, 0].tolist() == want and r[0, 0, 31] == 1
    assert torch.equal(h.reshape(256), torch.bincount(d.reshape(-1),
                                                      minlength=256))


def test_nibble_hist_to_digit_major_matches_jax():
    h = np.random.default_rng(0).integers(0, 1000, (3, 16, 16),
                                          dtype=np.uint32)
    got = rk.nibble_hist_to_digit_major(torch.from_numpy(h.view(np.int32)))
    assert got.shape == (256, 3)
    np.testing.assert_array_equal(_u32(got.contiguous()),
                                  np.asarray(jax_nibble(h)))


def test_cpu_tensors_launch_no_kernel():
    before = dict(LAUNCHES)
    k = U64.from_numpy(np.arange(300, dtype=np.uint64), "cpu")
    rk.block_rank_and_histogram_mxu(k.lo, k.hi, 0)
    assert LAUNCHES == before


def test_bad_arguments_raise():
    k = U64.from_numpy(np.arange(300, dtype=np.uint64), "cpu")
    with pytest.raises(ValueError):
        rk.block_rank_and_histogram_mxu(k.lo, k.hi, 57)
    with pytest.raises(ValueError):
        rk.block_rank_and_histogram_mxu(k.lo, k.hi, -1)
    with pytest.raises(ValueError):
        rk.block_rank_and_histogram_mxu(k.lo, k.hi, 0, block=0)
    with pytest.raises(ValueError):
        rk.block_rank_and_histogram_mxu(k.lo, k.hi[:10], 0)
