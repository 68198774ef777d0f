"""ctypes binding of the port's copy of the C++ core (cpp/core.cc).

The file is a byte-for-byte copy of the JAX package's tpu_qe/cpp/core.cc
(a test holds the two equal, so both packages keep one judge), compiled
here with g++ and that package's Makefile flags into the port's own build
directory: this package reads no file of tpu_qe and never imports it. The
core holds the host side of the pipeline: ChaCha8 scene generation, the
morton LUT builder and the CPU oracles that judge both packages bit for bit.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from tpu_qe_torch.utils.build import build_library

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cpp",
                    "core.cc")
# The JAX package's Makefile flags; -ffp-contract=off keeps float
# quantization op-exact.
_CXX = ["g++", "-O2", "-std=c++17", "-fPIC", "-ffp-contract=off",
        "-fvisibility=hidden", "-shared"]

# Flattened morton LUT sizes (u32 words): 9 x 256 u64 and 4096 u64.
LUT_U32_LEN = 4608
SIZE_LUT_U32_LEN = 8192

_lock = threading.Lock()
_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build_library("tpuqe_torch_core", [_SRC], _CXX))
        u64, u32 = ctypes.c_uint64, ctypes.c_uint32
        f32p = ctypes.POINTER(ctypes.c_float)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        voidp = ctypes.c_void_p
        lib.tq_scene_generate.argtypes = [u32, u32, u64, f32p, u32p, f32p, f32p]
        lib.tq_scene_generate.restype = None
        lib.tq_morton_gen_sizeof.argtypes = []
        lib.tq_morton_gen_sizeof.restype = u64
        lib.tq_morton_gen_init.argtypes = [f32p, f32p, voidp]
        lib.tq_morton_gen_init.restype = None
        lib.tq_morton_gen_flatten.argtypes = [voidp, u32p, u32p, f32p]
        lib.tq_morton_gen_flatten.restype = None
        lib.tq_morton_quantize.argtypes = [voidp, f32p, u32p, u64, u32p]
        lib.tq_morton_quantize.restype = None
        lib.tq_morton_encode.argtypes = [voidp, f32p, u32p, u64, u64p]
        lib.tq_morton_encode.restype = None
        lib.tq_morton_encode_quirk.argtypes = [voidp, f32p, u32p, u64, u64p]
        lib.tq_morton_encode_quirk.restype = None
        lib.tq_morton_encode_direct.argtypes = [u32p, u64, u64p]
        lib.tq_morton_encode_direct.restype = None
        lib.tq_lsd_sort.argtypes = [u64p, u32p, u64, u32, u32]
        lib.tq_lsd_sort.restype = None
        lib.tq_digit_major_histogram.argtypes = [u64p, u64, u32, u32, u32, u32p]
        lib.tq_digit_major_histogram.restype = None
        lib.tq_block_rank.argtypes = [u32p, u64, u32, u32p]
        lib.tq_block_rank.restype = None
        lib.tq_scatter_locations.argtypes = [u64p, u64, u32, u32, u32, u64p]
        lib.tq_scatter_locations.restype = None
        lib.tq_pipeline_oracle.argtypes = [u32, u32, u64, u64p, u32p]
        lib.tq_pipeline_oracle.restype = None
        _lib = lib
        return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def scene_generate(num_vertices: int, num_triangles: int, seed: int):
    """Seeded random scene (ChaCha8, seed_from_u64).

    Returns (vertices (V,3) f32, triangles (T,3) u32, scene_min, scene_max).
    """
    if num_vertices <= 0 or num_triangles < 0:
        raise ValueError(
            f"need num_vertices >= 1 (got {num_vertices}) and "
            f"num_triangles >= 0 (got {num_triangles})")
    lib = _load()
    verts = np.empty((num_vertices, 3), dtype=np.float32)
    tris = np.empty((num_triangles, 3), dtype=np.uint32)
    smin = np.empty(3, dtype=np.float32)
    smax = np.empty(3, dtype=np.float32)
    lib.tq_scene_generate(
        num_vertices, num_triangles, seed,
        _ptr(verts, ctypes.c_float), _ptr(tris, ctypes.c_uint32),
        _ptr(smin, ctypes.c_float), _ptr(smax, ctypes.c_float))
    return verts, tris, smin, smax


class MortonGen:
    """Extended-morton LUT generator: the uniforms and LUTs of a scene."""

    def __init__(self, scene_min: np.ndarray, scene_max: np.ndarray):
        lib = _load()
        self._buf = np.zeros(int(lib.tq_morton_gen_sizeof()), dtype=np.uint8)
        smin = np.ascontiguousarray(scene_min, dtype=np.float32)
        smax = np.ascontiguousarray(scene_max, dtype=np.float32)
        lib.tq_morton_gen_init(
            _ptr(smin, ctypes.c_float), _ptr(smax, ctypes.c_float),
            self._buf.ctypes.data_as(ctypes.c_void_p))
        lut = np.empty(LUT_U32_LEN, dtype=np.uint32)
        size_lut = np.empty(SIZE_LUT_U32_LEN, dtype=np.uint32)
        scalars = np.empty(8, dtype=np.float32)
        lib.tq_morton_gen_flatten(
            self._buf.ctypes.data_as(ctypes.c_void_p),
            _ptr(lut, ctypes.c_uint32), _ptr(size_lut, ctypes.c_uint32),
            _ptr(scalars, ctypes.c_float))
        self.offset = scalars[1:4].copy()
        self.size_multiplier = float(scalars[4])
        self.multiplier = scalars[5:8].copy()
        self.lut = lut.view(np.uint64).reshape(9, 256)
        self.size_lut = size_lut.view(np.uint64)

    def quantize(self, verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
        """(T, 4) u32 rows of (qx, qy, qz, size index)."""
        lib = _load()
        tris = np.ascontiguousarray(tris, dtype=np.uint32)
        verts = np.ascontiguousarray(verts, dtype=np.float32)
        n = tris.shape[0]
        q = np.empty((n, 4), dtype=np.uint32)
        lib.tq_morton_quantize(
            self._buf.ctypes.data_as(ctypes.c_void_p),
            _ptr(verts, ctypes.c_float), _ptr(tris, ctypes.c_uint32), n,
            _ptr(q, ctypes.c_uint32))
        return q

    def encode(self, verts: np.ndarray, tris: np.ndarray,
               quirk: bool = False) -> np.ndarray:
        """u64 morton codes of a triangle scene; quirk=True consumes the
        LUTs with the shipped reference kernel's i*3 byte shift."""
        lib = _load()
        tris = np.ascontiguousarray(tris, dtype=np.uint32)
        verts = np.ascontiguousarray(verts, dtype=np.float32)
        n = tris.shape[0]
        codes = np.empty(n, dtype=np.uint64)
        fn = lib.tq_morton_encode_quirk if quirk else lib.tq_morton_encode
        fn(self._buf.ctypes.data_as(ctypes.c_void_p),
           _ptr(verts, ctypes.c_float), _ptr(tris, ctypes.c_uint32), n,
           _ptr(codes, ctypes.c_uint64))
        return codes


def morton_encode_direct(q: np.ndarray) -> np.ndarray:
    """LUT-free bit-interleave encoding of quantized (qx, qy, qz, j) rows
    ((T, 4) u32) into u64 codes."""
    lib = _load()
    q = np.ascontiguousarray(q, dtype=np.uint32)
    if q.ndim != 2 or q.shape[1] != 4:
        raise ValueError(f"expected (T, 4) rows, got {q.shape}")
    n = q.shape[0]
    codes = np.empty(n, dtype=np.uint64)
    lib.tq_morton_encode_direct(_ptr(q, ctypes.c_uint32), n,
                                _ptr(codes, ctypes.c_uint64))
    return codes


def lsd_sort(keys: np.ndarray, payload: np.ndarray | None = None,
             bits_per_pass: int = 8, num_passes: int = 8):
    """Stable LSD radix sort oracle (in C++). Returns sorted copies."""
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.uint64).copy()
    n = keys.shape[0]
    if payload is not None:
        payload = np.ascontiguousarray(payload, dtype=np.uint32).copy()
        pp = _ptr(payload, ctypes.c_uint32)
    else:
        pp = ctypes.POINTER(ctypes.c_uint32)()
    lib.tq_lsd_sort(_ptr(keys, ctypes.c_uint64), pp, n, bits_per_pass,
                    num_passes)
    return (keys, payload) if payload is not None else keys


def digit_major_histogram(keys: np.ndarray, pass_number: int,
                          bits_per_pass: int, block_size: int) -> np.ndarray:
    """(radix, num_blocks) u32 counts of the digit at pass_number *
    bits_per_pass, digit-major."""
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    n = keys.shape[0]
    radix = 1 << bits_per_pass
    nb = -(-n // block_size)
    hist = np.empty(radix * nb, dtype=np.uint32)
    lib.tq_digit_major_histogram(_ptr(keys, ctypes.c_uint64), n, pass_number,
                                 bits_per_pass, block_size,
                                 _ptr(hist, ctypes.c_uint32))
    return hist.reshape(radix, nb)


def block_rank(digits: np.ndarray, radix: int) -> np.ndarray:
    """Occurrence index of each digit among equal digits before it."""
    lib = _load()
    digits = np.ascontiguousarray(digits, dtype=np.uint32)
    out = np.empty_like(digits)
    lib.tq_block_rank(_ptr(digits, ctypes.c_uint32), digits.shape[0], radix,
                      _ptr(out, ctypes.c_uint32))
    return out


def scatter_locations(keys: np.ndarray, pass_number: int, bits_per_pass: int,
                      block_size: int) -> np.ndarray:
    """Destination of every key in one LSD pass (u64)."""
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    n = keys.shape[0]
    out = np.empty(n, dtype=np.uint64)
    lib.tq_scatter_locations(_ptr(keys, ctypes.c_uint64), n, pass_number,
                             bits_per_pass, block_size,
                             _ptr(out, ctypes.c_uint64))
    return out


def pipeline_oracle(num_vertices: int, num_triangles: int, seed: int):
    """End-to-end CPU oracle: scene -> morton -> stable (code, index) sort."""
    lib = _load()
    codes = np.empty(num_triangles, dtype=np.uint64)
    idx = np.empty(num_triangles, dtype=np.uint32)
    lib.tq_pipeline_oracle(num_vertices, num_triangles, seed,
                           _ptr(codes, ctypes.c_uint64),
                           _ptr(idx, ctypes.c_uint32))
    return codes, idx
