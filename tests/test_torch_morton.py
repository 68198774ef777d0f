"""tpu_qe_torch.morton against tpu_qe.morton and the C++ encoders.

The same scene (C++ ChaCha8) and the same MortonParams, carried over from
the JAX package with MortonParams.from_reference, go through both packages.
Quantization and keys must be byte-exact (tolerance: exact equality).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_qe import morton as jmorton  # noqa: E402
from tpu_qe import native as jnative  # noqa: E402
from tpu_qe_torch import morton as tmorton  # noqa: E402
from tpu_qe_torch import native  # noqa: E402


def _scene(nv=1000, nt=3000, seed=7):
    verts, tris, smin, smax = native.scene_generate(nv, nt, seed)
    gen = jnative.MortonGen(smin, smax)
    jparams = jmorton.MortonParams.from_native(gen)
    tparams = tmorton.MortonParams.from_reference(
        {k: np.asarray(v) for k, v in jparams._asdict().items()}, "cpu")
    return verts, tris, gen, jparams, tparams


def _u32(t):
    return t.numpy().view(np.uint32)


def test_from_reference_carries_every_field():
    _, _, gen, jp, tp = _scene()
    for name in jp._fields:
        j, t = np.asarray(getattr(jp, name)), getattr(tp, name)
        if j.dtype == np.float32:
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), j)
        else:
            assert t.dtype == torch.int32
            np.testing.assert_array_equal(_u32(t), j)
    # the port's own LUT builder gives the same tensors
    own = tmorton.MortonParams.from_native(native.MortonGen(
        *native.scene_generate(1000, 3000, 7)[2:]), "cpu")
    for a, b in zip(own, tp):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed,nv,nt", [(7, 1000, 3000), (3, 500, 2000),
                                        (11, 200, 600)])
def test_quantize_matches_jax_and_native(seed, nv, nt):
    verts, tris, gen, jp, tp = _scene(nv, nt, seed)
    jq, jj = jmorton.quantize(jnp.asarray(verts),
                              jnp.asarray(tris.astype(np.int32)), jp)
    tq, tj = tmorton.quantize(torch.from_numpy(verts),
                              torch.from_numpy(tris.astype(np.int32)), tp)
    np.testing.assert_array_equal(_u32(tq), np.asarray(jq))
    np.testing.assert_array_equal(_u32(tj), np.asarray(jj))
    qj = gen.quantize(verts, tris)
    np.testing.assert_array_equal(_u32(tq), qj[:, :3])
    np.testing.assert_array_equal(_u32(tj), qj[:, 3])


@pytest.mark.parametrize("mode", ["direct", "lut", "quirk"])
def test_encode_matches_jax_and_native(mode):
    verts, tris, gen, jp, tp = _scene()
    kw = {"direct": {}, "lut": {"use_lut": True},
          "quirk": {"quirk_lut": True}}[mode]
    want_j = jmorton.encode(jnp.asarray(verts),
                            jnp.asarray(tris.astype(np.int32)), jp, **kw)
    got = tmorton.encode(torch.from_numpy(verts),
                         torch.from_numpy(tris.astype(np.int32)), tp, **kw)
    np.testing.assert_array_equal(_u32(got.lo), np.asarray(want_j.lo))
    np.testing.assert_array_equal(_u32(got.hi), np.asarray(want_j.hi))
    np.testing.assert_array_equal(got.to_numpy(),
                                  gen.encode(verts, tris,
                                             quirk=(mode == "quirk")))


def test_quirk_differs_from_resolved():
    verts, tris, _, _, tp = _scene()
    v, t = torch.from_numpy(verts), torch.from_numpy(tris.astype(np.int32))
    a = tmorton.encode(v, t, tp, use_lut=True).to_numpy()
    b = tmorton.encode(v, t, tp, quirk_lut=True).to_numpy()
    assert not np.array_equal(a, b)


def test_encode_quantized_random_cells_match_jax():
    # full 20-bit coordinate and 12-bit size range, both key constructions
    _, _, _, jp, tp = _scene(200, 600, 11)
    rng = np.random.default_rng(0)
    q = rng.integers(0, 1 << 20, (4000, 3), dtype=np.uint32)
    j = rng.integers(0, 1 << 12, 4000, dtype=np.uint32)
    tq, tj = (torch.from_numpy(q.view(np.int32)),
              torch.from_numpy(j.view(np.int32)))
    for quirk in (False, True):
        want = jmorton.encode_quantized_lut(jnp.asarray(q), jnp.asarray(j),
                                            jp, quirk_shift=quirk)
        got = tmorton.encode_quantized_lut(tq, tj, tp, quirk_shift=quirk)
        np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())
    want = jmorton.encode_quantized(jnp.asarray(q), jnp.asarray(j))
    got = tmorton.encode_quantized(tq, tj)
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())


def test_int64_triangle_indices_accepted():
    verts, tris, gen, _, tp = _scene(300, 900, 5)
    got = tmorton.encode(torch.from_numpy(verts),
                         torch.from_numpy(tris.astype(np.int64)), tp)
    np.testing.assert_array_equal(got.to_numpy(), gen.encode(verts, tris))


@pytest.mark.parametrize("level,axis", [(0, 0), (4, 2), (5, 0), (19, 2)])
def test_bit_positions_match_jax(level, axis):
    assert (tmorton.coord_bit_position(level, axis)
            == jmorton.coord_bit_position(level, axis))
    assert tmorton.size_bit_position(3) == jmorton.size_bit_position(3)
