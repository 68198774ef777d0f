"""tpu_qe_torch ORDER BY, top-k and set operations against the JAX package
on CPU tensors (the radix sort runs its kernels' plain twins here). Inputs
come from numpy seeds with bit-31 keys, ties, DESC / int32 / float32 keys
(signed zeros, infinities, NaN). Tolerance: exact equality of every column
(floats compared by bits), counts and padding (set_op pads with all-ones
keys and zero counts by its docstring).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_qe.bits import U64 as JU64  # noqa: E402
from tpu_qe.ops.orderby import sort_by_multi as jsort_by_multi  # noqa: E402
from tpu_qe.ops.setops import set_op as jset_op  # noqa: E402
from tpu_qe.ops.topk import top_k as jtop_k  # noqa: E402
from tpu_qe.table import Table as JTable  # noqa: E402
from tpu_qe_torch.bits import U64  # noqa: E402
from tpu_qe_torch.ops.orderby import sort_by_multi  # noqa: E402
from tpu_qe_torch.ops.setops import set_op  # noqa: E402
from tpu_qe_torch.ops.topk import top_k  # noqa: E402
from tpu_qe_torch.table import Table  # noqa: E402


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _same(t: Table, jt: JTable):
    got, want = t.to_numpy(), jt.to_numpy()
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]),
                                      err_msg=k)


def _table(n, seed):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(n).astype(np.float32).round(1)
    f[:6] = [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan]
    return {
        "a": (rng.integers(0, 6, n).astype(np.uint64) << np.uint64(31))
        | np.uint64(0x80000000),
        "b": rng.integers(-3, 3, n).astype(np.int32),
        "f": f,
        "u": rng.integers(0, 4, n).astype(np.uint32) << np.uint32(30),
        "pay": np.arange(n, dtype=np.uint32),
    }


@pytest.mark.parametrize("backend", ["radix", "torch"])
@pytest.mark.parametrize("by", [
    ["a"], [("a", "desc")], ["b", ("f", "desc")], [("u", "desc"), "a"],
    [("a", "desc"), "b", ("f", "desc")], ["f"], [("b", "desc"), "u", "f"]])
def test_order_by_matches_jax(by, backend):
    cols = _table(2000, len(by))
    t, jt = Table.from_numpy(cols, device="cpu"), JTable.from_numpy(cols)
    got = t.order_by(by, backend=backend)
    want = jsort_by_multi(jt, by)
    _same(got, want)


@pytest.mark.parametrize("largest", [False, True])
@pytest.mark.parametrize("k", [1, 17, 2000])
def test_top_k_matches_jax(k, largest):
    cols = _table(2000, k)
    cols["a"][::3] = np.uint64(0xFFFFFFFFFFFFFFFF)      # ties at the top
    t, jt = Table.from_numpy(cols, device="cpu"), JTable.from_numpy(cols)
    _same(top_k(t, k, key="a", largest=largest).table,
          jtop_k(jt, k, key="a", largest=largest).table)
    with pytest.raises(ValueError):
        top_k(t, 0, key="a")


@pytest.mark.parametrize("op", ["union", "intersect", "except"])
@pytest.mark.parametrize("sizes", [(1000, 500), (1, 1), (300, 0), (0, 40)])
def test_set_op_matches_jax_with_padding(op, sizes):
    rng = np.random.default_rng(sizes[0] + sizes[1])
    na, nb = sizes
    a = rng.integers(0, 200, na).astype(np.uint64) * np.uint64(0x80000001)
    b = rng.integers(100, 300, nb).astype(np.uint64) * np.uint64(0x80000001)
    got = set_op(U64.from_numpy(a, "cpu"), U64.from_numpy(b, "cpu"), op)
    want = jset_op(JU64.from_numpy(a), JU64.from_numpy(b), op)
    np.testing.assert_array_equal(got[0].to_numpy(), want[0].to_numpy())
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    expect = {"union": set(a) | set(b), "intersect": set(a) & set(b),
              "except": set(a) - set(b)}[op]
    assert int(got[3]) == len(expect)
    with pytest.raises(ValueError):
        set_op(U64.from_numpy(a, "cpu"), U64.from_numpy(b, "cpu"), "xor")
