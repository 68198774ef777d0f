"""tpu_qe_torch.sort.merge against tpu_qe.sort.merge on the inputs of
tests/test_merge.py: every output column, payloads included, bit for bit
(and against numpy's lexsort, as the reference tests hold it). The JAX
network sorts its last 256-row windows with lax.sort; the port runs the
network's own stages to the end, which gives the same rows because
(hi, lo, rank) is unique."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_qe.sort import merge as jm  # noqa: E402
from tpu_qe_torch.sort import merge as tm  # noqa: E402


def _make_run(rng, m, payloads=0):
    hi = rng.integers(0, 1 << 20, m, dtype=np.uint32)
    lo = rng.integers(0, 1 << 20, m, dtype=np.uint32)
    rk = rng.integers(0, 1 << 20, m, dtype=np.uint32)
    order = np.lexsort((rk, lo, hi))
    cols = [hi[order], lo[order], rk[order]]
    for p in range(payloads):
        cols.append(rng.integers(0, 1 << 31, m, dtype=np.uint32)[order])
    return cols


def _t(cols):
    return [torch.from_numpy(c.view(np.int32).copy()) for c in cols]


def _j(cols):
    return [jnp.asarray(c) for c in cols]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w))


def _oracle(cols):
    order = np.lexsort((cols[2], cols[1], cols[0]))
    return [c[order] for c in cols]


@pytest.mark.parametrize("m", [128, 1024, 4096])
def test_merge_two_runs_matches_numpy_and_jax(m):
    rng = np.random.default_rng(0)
    A, B = _make_run(rng, m), _make_run(rng, m)
    got = tm.bitonic_merge_cols(_t(A), _t(B))
    _same(got, jm.bitonic_merge_cols(_j(A), _j(B)))
    allc = [np.concatenate([a, b]) for a, b in zip(A, B)]
    for g, w in zip(got, _oracle(allc)):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), w)


def test_merge_carries_payloads():
    rng = np.random.default_rng(1)
    A, B = _make_run(rng, 512, payloads=2), _make_run(rng, 512, payloads=2)
    got = tm.bitonic_merge_cols(_t(A), _t(B))
    _same(got, jm.bitonic_merge_cols(_j(A), _j(B)))
    allc = [np.concatenate([a, b]) for a, b in zip(A, B)]
    rows = set(zip(*[g.numpy().view(np.uint32).tolist() for g in got]))
    assert rows == set(zip(*[c.tolist() for c in allc]))


def test_merge_tree_four_runs():
    rng = np.random.default_rng(2)
    runs = [_make_run(rng, 256) for _ in range(4)]
    got = tm.merge_tree([_t(r) for r in runs])
    _same(got, jm.merge_tree([_j(r) for r in runs]))
    allc = [np.concatenate([r[i] for r in runs]) for i in range(3)]
    for g, w in zip(got, _oracle(allc)):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), w)


def test_merge_tiny_runs():
    rng = np.random.default_rng(3)
    A, B = _make_run(rng, 8), _make_run(rng, 8)
    _same(tm.bitonic_merge_cols(_t(A), _t(B)),
          jm.bitonic_merge_cols(_j(A), _j(B)))


def test_keys_compare_unsigned_and_runs_batch():
    # words on both sides of 2^31, and two shards' runs merged at once
    rng = np.random.default_rng(4)

    def run(m):
        c = [rng.integers(0, 1 << 32, m, dtype=np.uint64).astype(np.uint32)
             for _ in range(4)]
        c[0] = (c[0] & np.uint32(1)) | np.uint32(0x7FFFFFFF)
        order = np.lexsort((c[2], c[1], c[0]))
        return [x[order] for x in c]

    A, B = [run(64) for _ in range(2)], [run(64) for _ in range(2)]
    got = tm.bitonic_merge_cols(
        [torch.stack([_t(a)[i] for a in A]) for i in range(4)],
        [torch.stack([_t(b)[i] for b in B]) for i in range(4)])
    for s in range(2):
        want = jm.bitonic_merge_cols(_j(A[s]), _j(B[s]))
        _same([g[s] for g in got], want)
    assert tm.lex_le3(_t([np.array([0x80000000], np.uint32)] * 3),
                      _t([np.array([0x7FFFFFFF], np.uint32)] * 3)).item() \
        is False
