"""B4 (tpu_qe_torch.kernels.morton) and the point encoder on CPU tensors,
against the JAX Pallas kernel (interpret mode, as tests/test_morton_kernel.py
runs it), JAX's LUT path, the port's size-LUT path and the C++ direct
encoder; the fused encode's wrappers (encode_triangles, encode_points) on
CPU tensors, whose plain twin must equal tpu_qe_torch.morton's quantize +
encode_quantized, the JAX package's encode and the C++ encoder. Inputs come
from numpy seeds; tolerance: exact equality.

The CUDA kernels themselves are held against these twins on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_qe import morton as jmorton  # noqa: E402
from tpu_qe import native as jnative  # noqa: E402
from tpu_qe.kernels.morton import encode_quantized_lut as pallas_lut  # noqa: E402
from tpu_qe_torch import morton, native  # noqa: E402
from tpu_qe_torch.kernels import LAUNCHES  # noqa: E402
from tpu_qe_torch.kernels import morton as mk  # noqa: E402


def _params(seed=7):
    """JAX MortonParams of a seeded scene and the port's, carried over."""
    _, _, smin, smax = native.scene_generate(200, 600, seed)
    jp = jmorton.MortonParams.from_native(jnative.MortonGen(smin, smax))
    tp = morton.MortonParams.from_reference(
        {k: np.asarray(v) for k, v in jp._asdict().items()}, "cpu")
    return jp, tp


def _cells(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1 << 20, (n, 3), dtype=np.uint32),
            rng.integers(0, 1 << 12, n, dtype=np.uint32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(
        np.int32))


@pytest.mark.parametrize("quirk", [False, True])
@pytest.mark.parametrize("n", [1024, 3072])
def test_twin_matches_pallas_kernel(n, quirk):
    jp, tp = _params()
    q, j = _cells(n, n)
    want = pallas_lut(jnp.asarray(q), jnp.asarray(j), jp.lut_lo, jp.lut_hi,
                      block_rows=8, quirk_shift=quirk)
    got = mk.encode_quantized_lut(_t(q), _t(j), tp.lut_lo, tp.lut_hi,
                                  quirk_shift=quirk)
    np.testing.assert_array_equal(got.lo.numpy().view(np.uint32),
                                  np.asarray(want.lo))
    np.testing.assert_array_equal(got.hi.numpy().view(np.uint32),
                                  np.asarray(want.hi))


@pytest.mark.parametrize("quirk", [False, True])
@pytest.mark.parametrize("n", [0, 1, 1023, 5000])
def test_twin_matches_jax_lut_path_at_any_n(n, quirk):
    jp, tp = _params(11)
    q, j = _cells(n, 3 + n)
    want = jmorton.encode_quantized_lut(jnp.asarray(q), jnp.asarray(j), jp,
                                        quirk_shift=quirk)
    got = mk.encode_quantized_lut(_t(q), _t(j), tp.lut_lo, tp.lut_hi,
                                  quirk_shift=quirk)
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())
    # the port's own LUT path (size LUT) agrees
    via = morton.encode_quantized_lut(_t(q), _t(j), tp, quirk_shift=quirk)
    np.testing.assert_array_equal(got.to_numpy(), via.to_numpy())


@pytest.mark.parametrize("n", [1, 2048, 4097])
def test_twin_matches_native_direct_encode(n):
    _, tp = _params(3)
    q, j = _cells(n, n)
    got = mk.encode_quantized_lut(_t(q), _t(j), tp.lut_lo, tp.lut_hi)
    want = native.morton_encode_direct(np.concatenate([q, j[:, None]],
                                                      axis=1))
    np.testing.assert_array_equal(got.to_numpy(), want)
    np.testing.assert_array_equal(
        want, jnative.morton_encode_direct(np.concatenate([q, j[:, None]],
                                                          axis=1)))


@pytest.mark.parametrize("quirk", [False, True])
def test_direct_size_bits_equal_the_size_lut_for_every_j(quirk):
    # every 12-bit size index, plus indices with bits above bit 11 (the
    # size LUT masks them; the direct placement never reads them)
    _, tp = _params(5)
    j = np.concatenate([np.arange(4096, dtype=np.uint32),
                        np.array([4096, 0xABCDE, 0xFFFFFFFF], np.uint32)])
    q = np.zeros((j.shape[0], 3), dtype=np.uint32)
    got = mk.encode_quantized_lut(_t(q), _t(j), tp.lut_lo, tp.lut_hi,
                                  quirk_shift=quirk)
    via = morton.encode_quantized_lut(_t(q), _t(j), tp, quirk_shift=quirk)
    np.testing.assert_array_equal(got.to_numpy(), via.to_numpy())


def test_reference_params_feed_the_kernel_luts():
    # MortonParams.from_reference carries the JAX LUT words unchanged
    jp, tp = _params(13)
    for name in ("lut_lo", "lut_hi"):
        t = getattr(tp, name)
        assert t.shape == (9, 256) and t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy().view(np.uint32),
                                      np.asarray(getattr(jp, name)))


@pytest.mark.parametrize("with_size", [False, True])
@pytest.mark.parametrize("n", [1, 500, 2048])
def test_encode_points_matches_jax(n, with_size):
    jp, tp = _params(3)
    rng = np.random.default_rng(n)
    pts = (rng.uniform(-1, 1, (n, 3)) * 60).astype(np.float32)
    size = (rng.uniform(0, 5, n).astype(np.float32) if with_size else None)
    jsize = None if size is None else jnp.asarray(size)
    tsize = None if size is None else torch.from_numpy(size)
    jq, jj = jmorton.quantize_points(*(jnp.asarray(pts[:, i])
                                       for i in range(3)), jsize, jp)
    tq, tj = morton.quantize_points(*(torch.from_numpy(pts[:, i].copy())
                                      for i in range(3)), tsize, tp)
    np.testing.assert_array_equal(tq.numpy().view(np.uint32), np.asarray(jq))
    np.testing.assert_array_equal(tj.numpy().view(np.uint32), np.asarray(jj))
    want = jmorton.encode_points(*(jnp.asarray(pts[:, i]) for i in range(3)),
                                 jp, size=jsize)
    got = morton.encode_points(*(torch.from_numpy(pts[:, i].copy())
                                 for i in range(3)), tp, size=tsize)
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())


def test_points_equal_degenerate_triangles():
    _, tp = _params(3)
    pts = (np.random.default_rng(4).uniform(-1, 1, (500, 3)) * 50).astype(
        np.float32)
    tris = np.repeat(np.arange(500, dtype=np.int32)[:, None], 3, axis=1)
    want = morton.encode(torch.from_numpy(pts), torch.from_numpy(tris), tp)
    got = morton.encode_points(*(torch.from_numpy(pts[:, i].copy())
                                 for i in range(3)), tp)
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())


def test_cpu_tensors_launch_no_kernel():
    before = dict(LAUNCHES)
    _, tp = _params()
    q, j = _cells(100, 0)
    mk.encode_quantized_lut(_t(q), _t(j), tp.lut_lo, tp.lut_hi)
    assert LAUNCHES == before


def test_bad_arguments_raise():
    _, tp = _params()
    q, j = _t(np.zeros((10, 3))), _t(np.zeros(10))
    with pytest.raises(ValueError):
        mk.encode_quantized_lut(q[:, :2], j, tp.lut_lo, tp.lut_hi)
    with pytest.raises(ValueError):
        mk.encode_quantized_lut(q, j[:5], tp.lut_lo, tp.lut_hi)
    with pytest.raises(ValueError):
        mk.encode_quantized_lut(q, j, tp.lut_lo[:8], tp.lut_hi)
    with pytest.raises(ValueError):
        mk.encode_quantized_lut(q.to(torch.int64), j, tp.lut_lo, tp.lut_hi)
    with pytest.raises(ValueError):                   # not contiguous
        mk.encode_quantized_lut(_t(np.zeros((3, 10))).T, j, tp.lut_lo,
                                tp.lut_hi)


def _odd_scene(nt, seed):
    """A seeded scene of nt triangles over nt // 3 + 1 vertices with
    vertices outside the box on both sides (cells clamped at 0 and at
    2^20 - 1), degenerate triangles (all corners one vertex) and long
    triangles whose size index clamps at 4095."""
    nv = nt // 3 + 1
    verts, tris, smin, smax = native.scene_generate(nv, nt, seed)
    rng = np.random.default_rng(seed)
    verts = verts.copy()
    far = rng.integers(0, nv, max(nv // 5, 1))
    ext = smax - smin
    verts[far] = (smin + (rng.uniform(-1.5, 2.5, (far.shape[0], 3))
                          * ext)).astype(np.float32)
    tris = tris.astype(np.int64)
    tris[::7] = tris[::7, :1]
    gen = jnative.MortonGen(smin, smax)
    jp = jmorton.MortonParams.from_native(gen)
    tp = morton.MortonParams.from_reference(
        {k: np.asarray(v) for k, v in jp._asdict().items()}, "cpu")
    return verts, tris, gen, jp, tp


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("nt", [1, 1000, 4097])
def test_fused_encode_twin_matches_plain_jax_and_native(nt, index_dtype):
    verts, tris, gen, jp, tp = _odd_scene(nt, nt)
    v = torch.from_numpy(verts)
    t = torch.from_numpy(tris).to(index_dtype)
    before = dict(LAUNCHES)
    got = mk.encode_triangles(v, t, tp)
    via = morton.encode(v, t, tp)
    assert LAUNCHES == before
    plain = morton.encode_quantized(*morton.quantize(v, t, tp))
    np.testing.assert_array_equal(got.to_numpy(), plain.to_numpy())
    np.testing.assert_array_equal(via.to_numpy(), plain.to_numpy())
    want = jmorton.encode(jnp.asarray(verts),
                          jnp.asarray(tris.astype(np.int32)), jp)
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())
    np.testing.assert_array_equal(got.to_numpy(), gen.encode(verts, tris))
    # the scene reaches both clamps of the cells and of the size index
    q = gen.quantize(verts, tris)
    if nt > 1:
        assert (q[:, :3] == 0).any() and (q[:, :3] == (1 << 20) - 1).any()
        assert (q[:, 3] == 4095).any() and (q[:, 3] == 0).any()


@pytest.mark.parametrize("with_size", [False, True])
@pytest.mark.parametrize("n", [1, 1000, 4097])
def test_fused_point_encode_twin_matches_plain_and_jax(n, with_size):
    jp, tp = _params(9)
    rng = np.random.default_rng(100 + n)
    pts = (rng.uniform(-1, 1, (n, 3)) * 90).astype(np.float32)
    size = (rng.uniform(0, 400, n).astype(np.float32) if with_size
            else None)
    cols = [torch.from_numpy(pts[:, i].copy()) for i in range(3)]
    tsize = None if size is None else torch.from_numpy(size)
    before = dict(LAUNCHES)
    got = mk.encode_points(*cols, tsize, tp)
    assert LAUNCHES == before
    plain = morton.encode_quantized(*morton.quantize_points(*cols, tsize, tp))
    np.testing.assert_array_equal(got.to_numpy(), plain.to_numpy())
    want = jmorton.encode_points(*(jnp.asarray(pts[:, i]) for i in range(3)),
                                 jp, size=None if size is None
                                 else jnp.asarray(size))
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())


def test_fused_encode_of_nothing_on_cpu():
    _, tp = _params()
    for dtype in (torch.int32, torch.int64):
        got = mk.encode_triangles(torch.zeros((4, 3)),
                                  torch.zeros((0, 3), dtype=dtype), tp)
        assert got.lo.shape == got.hi.shape == (0,)
    got = mk.encode_points(*(torch.zeros(0),) * 3, None, tp)
    assert got.lo.shape == (0,)


def test_fused_encode_bad_arguments_raise():
    _, tp = _params()
    v = torch.zeros((10, 3))
    t = torch.zeros((4, 3), dtype=torch.int32)
    x = torch.zeros(10)
    meta = torch.device("meta")
    cases = [
        lambda: mk.encode_triangles(v[:, :2], t, tp),             # shapes
        lambda: mk.encode_triangles(v.reshape(-1), t, tp),
        lambda: mk.encode_triangles(v, t[:, :2], tp),
        lambda: mk.encode_triangles(v.double(), t, tp),           # dtypes
        lambda: mk.encode_triangles(v, t.to(torch.int16), tp),
        lambda: mk.encode_triangles(v, t.float(), tp),
        lambda: mk.encode_triangles(v.T.contiguous().T, t, tp),   # strides
        lambda: mk.encode_triangles(v, t.T.contiguous().T, tp),
        lambda: mk.encode_triangles(v, t.to(meta), tp),           # devices
        lambda: mk.encode_triangles(v.to(meta), t.to(meta), tp),
        lambda: mk.encode_triangles(
            v, t, tp._replace(offset=tp.offset.to(meta))),
        lambda: mk.encode_triangles(
            v, t, tp._replace(multiplier=tp.multiplier.double())),
        lambda: mk.encode_triangles(
            v, t, tp._replace(size_multiplier=tp.size_multiplier[None])),
        lambda: mk.encode_points(x, x, x[:5], None, tp),
        lambda: mk.encode_points(x, x, x, x[:9], tp),
        lambda: mk.encode_points(x, x.double(), x, None, tp),
        lambda: mk.encode_points(x, x, x.to(torch.int32), None, tp),
        lambda: mk.encode_points(x, x, x, torch.zeros(20)[::2], tp),
        lambda: mk.encode_points(x.reshape(2, 5), x.reshape(2, 5),
                                 x.reshape(2, 5), None, tp),
        lambda: mk.encode_points(x, x, x.to(meta), None, tp),
        lambda: mk.encode_points(x, x, x, None,
                                 tp._replace(offset=tp.offset.to(meta))),
    ]
    for i, bad in enumerate(cases):
        with pytest.raises(ValueError):
            bad()
