"""tpu_qe_torch.utils.checkpoint against tpu_qe.utils.checkpoint: the same
npz layouts, so each package loads what the other wrote (through the
files, not a code import). Tolerance: exact equality."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_qe.bits import U64 as JU64  # noqa: E402
from tpu_qe.table import Table as JTable  # noqa: E402
from tpu_qe.utils import checkpoint as jck  # noqa: E402
from tpu_qe_torch.bits import U64  # noqa: E402
from tpu_qe_torch.table import Table, column_from_numpy  # noqa: E402
from tpu_qe_torch.utils import checkpoint as tck  # noqa: E402

META = np.asarray([1 << 13, 1 << 11, 4, 7, 4096, 1, 1], np.int64)


def _bounds():
    return np.arange(12, dtype=np.int32).reshape(4, 3) * 100


@pytest.mark.parametrize("writer,reader", [(tck, jck), (jck, tck),
                                           (tck, tck)])
def test_run_state_written_by_one_package_loads_in_the_other(tmp_path,
                                                             writer, reader):
    st = writer.RunState.fresh(str(tmp_path), META, _bounds(), 4)
    st.record(2, [1, 1, 2048, 5, 6, 0xFFFFFFFF, 0, 7, 8])
    st.record(0, [1, 0, 1, 2, 3, 4, 5, 6, 7])
    got = reader.RunState.load(str(tmp_path), META)
    assert got is not None and got.path == st.path
    np.testing.assert_array_equal(got.bounds, _bounds())
    assert got.bounds.dtype == np.int32
    np.testing.assert_array_equal(got.done, [1, 0, 1, 0])
    np.testing.assert_array_equal(got.scalars[2],
                                  [1, 1, 2048, 5, 6, 0xFFFFFFFF, 0, 7, 8])
    assert got.scalars.dtype == np.int64 and got.done.dtype == np.int64
    assert reader.RunState.N_SCALARS == writer.RunState.N_SCALARS == 9


def test_run_state_files_are_the_same_bytes_of_npz_fields(tmp_path):
    for pkg, sub in ((tck, "port"), (jck, "jax")):
        d = tmp_path / sub
        d.mkdir()
        pkg.RunState.fresh(str(d), META, _bounds(), 4).record(
            1, range(9))
    with np.load(tmp_path / "port" / "bigsort_state.npz") as a, \
            np.load(tmp_path / "jax" / "bigsort_state.npz") as b:
        assert sorted(a.files) == sorted(b.files) == ["bounds", "done",
                                                      "meta", "scalars"]
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_mismatched_meta_or_no_file_starts_afresh(tmp_path):
    assert tck.RunState.load(str(tmp_path), META) is None
    tck.RunState.fresh(str(tmp_path), META, _bounds(), 4)
    other = META.copy()
    other[2] = 8
    assert tck.RunState.load(str(tmp_path), other) is None
    assert jck.RunState.load(str(tmp_path), other) is None
    assert tck.RunState.load(str(tmp_path), META) is not None


def test_run_state_writes_through_a_temporary_file(tmp_path):
    st = tck.RunState.fresh(str(tmp_path), META, _bounds(), 4)
    st.record(3, range(9))
    assert sorted(os.listdir(tmp_path)) == ["bigsort_state.npz"]
    assert st.path == os.path.join(str(tmp_path), "bigsort_state.npz")


def _cols():
    rng = np.random.default_rng(2)
    return {"k": rng.integers(0, 1 << 64, 50, dtype=np.uint64),
            "u": rng.integers(0, 1 << 32, 50, dtype=np.uint64)
            .astype(np.uint32),
            "i": rng.integers(-9, 9, 50).astype(np.int32),
            "f": rng.standard_normal(50).astype(np.float32)}


def _same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_npz_tables_cross_between_the_packages(tmp_path):
    cols = _cols()
    t = Table.from_numpy(cols, device="cpu")
    path = tck.save_table_npz(t, str(tmp_path / "port.npz"))
    assert path == os.path.abspath(str(tmp_path / "port.npz"))
    _same(tck.load_table_npz(path, device="cpu").to_numpy(), cols)
    _same(jck.load_table_npz(path).to_numpy(), cols)
    jt = JTable({k: JU64.from_numpy(v) if v.dtype == np.uint64
                 else jnp.asarray(v) for k, v in cols.items()})
    jpath = jck.save_table_npz(jt, str(tmp_path / "jax.npz"))
    _same(tck.load_table_npz(jpath, device="cpu").to_numpy(), cols)
    # Table.save / Table.load go through the same module
    _same(Table.load(t.save(str(tmp_path / "t")), device="cpu").to_numpy(),
          cols)


def test_npz_refuses_the_u64_plane_suffixes(tmp_path):
    t = Table({"x@hi": column_from_numpy(np.zeros(3, np.uint32), "cpu")})
    with pytest.raises(ValueError, match="@lo"):
        tck.save_table_npz(t, str(tmp_path / "bad.npz"))


def test_load_table_npz_defaults_to_the_card(tmp_path):
    path = tck.save_table_npz(Table.from_numpy(_cols(), device="cpu"),
                              str(tmp_path / "c.npz"))
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        tck.load_table_npz(path)


def test_orbax_checkpoints_name_the_missing_package(tmp_path):
    t = Table({"u": U64.from_numpy(np.arange(3, dtype=np.uint64), "cpu")})
    with pytest.raises(ImportError, match="orbax"):
        tck.save_table(t, str(tmp_path / "ckpt"))
    with pytest.raises(ImportError, match="orbax"):
        tck.load_table(str(tmp_path / "ckpt"), device="cpu")
