"""Runtime configuration: dataclasses with validation, overridable from the
CLI (python -m tpu_qe_torch) and from the environment (TPU_QE_TORCH_*)."""

from __future__ import annotations

import dataclasses
import os

import torch

from tpu_qe_torch import constants

BACKENDS = ("radix", "torch")


def _env(name: str, default, cast):
    v = os.environ.get(f"TPU_QE_TORCH_{name}")
    return default if v is None else cast(v)


def resolve_device(name: str | torch.device) -> torch.device:
    """The torch device for `name`; a CUDA device without CUDA raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not "
                           "available on this machine")
    return dev


@dataclasses.dataclass(frozen=True)
class SortConfig:
    """LSD radix sort configuration."""

    bits_per_pass: int = constants.BITS_PER_PASS
    num_passes: int = constants.NUM_PASSES
    block: int = constants.BLOCK
    backend: str = "radix"

    def __post_init__(self):
        if not (1 <= self.bits_per_pass <= 16):
            raise ValueError(f"bits_per_pass out of range: {self.bits_per_pass}")
        # The last pass must start inside the 64-bit key (the reference's
        # 6-bit/11-pass variant covers 66 bits; its last pass reads the top
        # 4 real bits).
        if self.bits_per_pass * (self.num_passes - 1) >= 64:
            raise ValueError("pass schedule extends past the 64-bit key")
        if self.block < 1:
            raise ValueError(f"block must be positive: {self.block}")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"expected one of {BACKENDS}")

    @property
    def key_bits(self) -> int:
        return min(self.bits_per_pass * self.num_passes, 64)


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """Seeded random scene."""

    num_vertices: int = constants.NUM_VERTICES
    num_triangles: int = constants.NUM_TRIANGLES
    seed: int = constants.RNG_SEED

    def __post_init__(self):
        if self.num_vertices <= 0 or self.num_triangles <= 0:
            raise ValueError("scene sizes must be positive")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Top-level engine config; env overrides via TPU_QE_TORCH_<FIELD>."""

    sort: SortConfig = dataclasses.field(default_factory=SortConfig)
    scene: SceneConfig = dataclasses.field(default_factory=SceneConfig)
    # Directory for torch.profiler Chrome traces.
    trace_dir: str | None = None
    verbose: bool = False

    @staticmethod
    def from_env() -> "EngineConfig":
        return EngineConfig(
            sort=SortConfig(
                bits_per_pass=_env("BITS_PER_PASS", constants.BITS_PER_PASS, int),
                num_passes=_env("NUM_PASSES", constants.NUM_PASSES, int),
                block=_env("BLOCK", constants.BLOCK, int),
                backend=_env("BACKEND", "radix", str),
            ),
            scene=SceneConfig(
                num_vertices=_env("NUM_VERTICES", constants.NUM_VERTICES, int),
                num_triangles=_env("NUM_TRIANGLES", constants.NUM_TRIANGLES, int),
                seed=_env("SEED", constants.RNG_SEED, int),
            ),
            trace_dir=_env("TRACE_DIR", None, str),
            verbose=bool(_env("VERBOSE", 0, int)),
        )
