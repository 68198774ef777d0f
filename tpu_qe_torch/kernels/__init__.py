"""Hand-written Hopper kernels (CUDA C++, sm_90a) and their plain twins.

The CUDA library is built at first use from tpu_qe_torch/csrc/*.cu with
nvcc into the package's build directory, and rebuilt when a source is newer.
It has a plain C interface and is loaded with ctypes: no PyTorch headers,
so a build takes seconds. A wrapper launches its kernel for CUDA tensors
and uses its plain PyTorch twin for CPU tensors only; a failed build or a
refused launch raises.

LAUNCHES counts, per wrapper, the launches of its kernel (never those of
its plain twin), so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import threading

import torch

from tpu_qe_torch.utils.build import build_library

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES = {
    "block_histogram": 0,
    "exclusive_scan": 0,
    "block_rank_and_histogram": 0,
    "rank_and_scatter": 0,
    "encode_quantized_lut": 0,
    "sort_chunks": 0,
    "block_rank_and_histogram_mxu": 0,
    "encode_triangles": 0,
    "encode_points": 0,
    "group_sums": 0,
    "join_probe": 0,
    "join_emit": 0,
}

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                           "/usr/local/cuda/bin): cannot build the kernels")
    return path


def library() -> ctypes.CDLL:
    """The CUDA kernel library, built from csrc/*.cu if missing or stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
        path = build_library("tpuqe_kernels", sources,
                             [_nvcc_path()] + NVCC_FLAGS)
        lib = ctypes.CDLL(path)
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.tq_cuda_error_string.argtypes = [i]
        lib.tq_cuda_error_string.restype = ctypes.c_char_p
        lib.tq_block_histogram.argtypes = [p, p, i64, i64, i, i, p, i, p]
        lib.tq_block_histogram.restype = i
        lib.tq_block_rank_and_histogram.argtypes = [p, p, i64, i64, i, i, p,
                                                    p, i, p]
        lib.tq_block_rank_and_histogram.restype = i
        lib.tq_rank_and_scatter.argtypes = [p, p, i64, i64, i, i, p, p, p, p,
                                            p, i, i, p]
        lib.tq_rank_and_scatter.restype = i
        lib.tq_exclusive_scan_scratch.argtypes = [i64]
        lib.tq_exclusive_scan_scratch.restype = i64
        lib.tq_exclusive_scan.argtypes = [p, p, p, i64, i, p]
        lib.tq_exclusive_scan.restype = i
        lib.tq_empty_launch.argtypes = [i, p]
        lib.tq_empty_launch.restype = i
        lib.tq_morton_encode_lut.argtypes = [p, p, p, p, i64, i, p, p, i, p]
        lib.tq_morton_encode_lut.restype = i
        lib.tq_morton_encode_triangles.argtypes = [p, p, i, i64, p, p, p, p,
                                                   p, i, p]
        lib.tq_morton_encode_triangles.restype = i
        lib.tq_morton_encode_points.argtypes = [p, p, p, p, i64, p, p, p, p,
                                                p, i, p]
        lib.tq_morton_encode_points.restype = i
        lib.tq_sort_chunks.argtypes = [p, p, i, i64, i64, p, i, p]
        lib.tq_sort_chunks.restype = i
        lib.tq_sort_chunks_tile.argtypes = [i64, i, i]
        lib.tq_sort_chunks_tile.restype = i64
        lib.tq_block_rank_and_histogram_mxu.argtypes = [p, p, i64, i64, i, p,
                                                        p, i, p]
        lib.tq_block_rank_and_histogram_mxu.restype = i
        lib.tq_group_sums_scratch.argtypes = [i64, i]
        lib.tq_group_sums_scratch.restype = i64
        lib.tq_group_sums.argtypes = [p, p, p, p, i, i64, p, ctypes.c_uint32,
                                      i, i64, p, p, p, p, p, p, p, p, i, p]
        lib.tq_group_sums.restype = i
        lib.tq_join_probe.argtypes = [p, p, i64, p, p, i64, p, p, p, i, p]
        lib.tq_join_probe.restype = i
        lib.tq_join_emit.argtypes = [p, p, p, i64, p, i64, p, p, i, p]
        lib.tq_join_emit.restype = i
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, code: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib.tq_cuda_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"error {code} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def empty_launch(device: torch.device) -> None:
    """Launch a kernel that does nothing on the device's current stream:
    timed, it is the floor under any kernel's time (csrc/scan.cu). It is no
    kernel of the port and counts in no entry of LAUNCHES."""
    lib = library()
    check(lib, lib.tq_empty_launch(
        device.index, torch.cuda.current_stream(device).cuda_stream),
        "empty_launch")


def require_planes(*planes: torch.Tensor) -> torch.device:
    """Check that all planes are contiguous 1-D int32 tensors of one length
    on one device; returns that device."""
    dev, n = planes[0].device, planes[0].shape
    for t in planes:
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError("expected contiguous 1-D int32 planes, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev or t.shape != n:
            raise ValueError("planes differ in device or length")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev
