"""The port's ChaCha8 streams, digit oracles and dump loaders
(tpu_qe_torch.native, tpu_qe_torch.utils.dump) against the JAX package's
(tpu_qe.native, tpu_qe.utils.dump) and the reference's own cases: the
published ChaCha8 keystream vector, the digit tests of every pass, and the
dump round trip. Tolerance: exact equality."""

import numpy as np
import pytest

from tpu_qe import native as jnative
from tpu_qe.utils import dump as jdump
from tpu_qe_torch import native
from tpu_qe_torch.utils import dump


def test_chacha8_raw_block_matches_published_vector_and_jax():
    out = native.chacha8_raw_block(bytes(32), 0)
    assert out.tobytes()[:32].hex() == ("3e00ef2f895f40d67f5bb8e81f09a5a1"
                                        "2c840ec3ce9a7f3b181be188ef711a1e")
    key = bytes(range(32))
    for counter in (0, 1, 1 << 40):
        np.testing.assert_array_equal(native.chacha8_raw_block(key, counter),
                                      jnative.chacha8_raw_block(key, counter))


@pytest.mark.parametrize("seed", [7, 8, 1 << 40])
def test_chacha8_streams_match_jax(seed):
    a = native.chacha8_u32(seed, 1000)
    assert a.dtype == np.uint32
    np.testing.assert_array_equal(a, jnative.chacha8_u32(seed, 1000))
    np.testing.assert_array_equal(a, native.chacha8_u32(seed, 1000))
    assert (a != native.chacha8_u32(seed + 1, 1000)).any()
    f = native.chacha8_f32(seed, 10000)
    np.testing.assert_array_equal(f.view(np.uint32),
                                  jnative.chacha8_f32(seed, 10000).view(
                                      np.uint32))
    assert (f >= 0).all() and (f < 1).all()
    assert np.allclose(f * (1 << 24), np.round(f * (1 << 24)))


def test_select_digit_oracles_match_the_reference_cases_and_jax():
    for i in range(8):
        y = (255 << (i * 8)) & ((1 << 64) - 1)
        assert native.select_digit8(i, y & 0xFFFFFFFF, y >> 32) == 255
    for i in range(11):
        y = (63 << (i * 6)) & ((1 << 64) - 1)
        assert native.select_digit6(i, y & 0xFFFFFFFF, y >> 32) == (
            63 if i < 10 else 15)
    rng = np.random.default_rng(0)
    for lo, hi in rng.integers(0, 1 << 32, (50, 2), dtype=np.uint64):
        lo, hi = int(lo), int(hi)
        for p in range(8):
            assert native.select_digit8(p, lo, hi) == \
                jnative.select_digit8(p, lo, hi)
        for p in range(11):
            assert native.select_digit6(p, lo, hi) == \
                jnative.select_digit6(p, lo, hi)


def test_dump_loaders_round_trip_and_match_jax(tmp_path):
    codes = np.array([0, 1, 2**63 + 5, 2**64 - 1], dtype=np.uint64)
    tris = np.array([[1, 2, 3], [4, 5, 6]], dtype=np.uint32)
    p1 = dump.dump_morton_codes(codes, str(tmp_path / "codes.txt"))
    p2 = dump.dump_indices(tris, str(tmp_path / "idx.txt"))
    for load, p, want in ((dump.load_morton_codes, p1, codes),
                          (dump.load_indices, p2, tris)):
        got = load(p)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(dump.load_morton_codes(p1),
                                  jdump.load_morton_codes(p1))
    np.testing.assert_array_equal(dump.load_indices(p2),
                                  jdump.load_indices(p2))
    assert open(p2).read().splitlines()[0] == "(1, 2, 3)"
    verts, tris, smin, smax = native.scene_generate(100, 300, 7)
    codes = native.MortonGen(smin, smax).encode(verts, tris)
    p = dump.dump_morton_codes(codes, str(tmp_path / "scene.txt"))
    np.testing.assert_array_equal(dump.load_morton_codes(p), codes)
    p = dump.dump_indices(tris, str(tmp_path / "scene_idx.txt"))
    np.testing.assert_array_equal(dump.load_indices(p),
                                  tris.astype(np.uint32))
