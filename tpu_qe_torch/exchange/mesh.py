"""The mesh of shards: the port's counterpart of JAX's ``Mesh``,
``shard_map`` and the ``AXIS`` collectives.

A shard body is written once, in the JAX package's SPMD style, over
tensors that carry a leading local-shard axis: shape (S, n_local), row s
being this process's s-th shard. Its collectives are methods of the mesh:

  all_gather(x)   (S, m, ...) -> (S, D*m, ...): every shard sees the
                  concatenation of all D shards' blocks in rank order
  all_to_all(x)   (S, D, ...) -> (S, D, ...): shard s receives, in block
                  j, the block that rank j sent to s
  pmax(x)         (S, ...) int64 -> the maximum over all D shards
  psum(x)         (S, ...) -> the int64 sum over all D shards, on every
                  shard
  ranks()         (S,) int64: the rank of each local shard
  shard(x)        a global (n, ...) tensor -> this process's (S, n/D, ...)
  collect(x)      (S, ...) -> (D, ...): every shard of the mesh
  barrier()       wait for every rank (a checkpoint that rank 0 writes is
                  complete when it returns)

Two backends hold the shards:

- ``LocalMesh(n_dev, device)`` holds all S = D shards on one device. It
  is the counterpart of XLA's forced host device count, on which the JAX
  package's distributed tests and dry runs run (8 virtual devices of one
  host). Its collectives are tensor operations: all_to_all is a transpose
  of the first two axes, a copy in the device's memory. One H100 runs the
  distributed operators at D > 1 this way; NCCL does not put two ranks
  on one GPU, and a mesh of one rank takes the operators' degenerate
  one-device paths. A LocalMesh never spans two devices.
- ``GroupMesh(group)`` runs one rank per process over
  ``torch.distributed`` (gloo on the CPU, NCCL across cards), S = 1. Its
  collectives are ``all_gather``, ``all_to_all_single`` with equal splits
  of the padded (D, c) blocks, and ``all_reduce`` (MAX and SUM). Several cards
  take a GroupMesh, one process per card.

Both keep the JAX package's padded fixed-capacity exchange
(exchange/shuffle.py): blocks of equal size, exact counts, an overflow
flag.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpu_qe_torch.config import resolve_device


class LocalMesh:
    """D shards on one device (S = D)."""

    def __init__(self, n_dev: int, device: str | torch.device = "cuda"):
        if n_dev < 1:
            raise ValueError(f"a mesh needs at least one shard, got {n_dev}")
        self.n_dev = int(n_dev)
        self.device = resolve_device(device)

    def ranks(self) -> torch.Tensor:
        return torch.arange(self.n_dev, device=self.device)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % self.n_dev:
            raise ValueError(f"{x.shape[0]} rows do not split over "
                             f"{self.n_dev} shards")
        return x.to(self.device).reshape(self.n_dev, -1, *x.shape[1:])

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        # every shard's view of the same concatenation: no copy
        cat = x.reshape(1, -1, *x.shape[2:])
        return cat.expand(self.n_dev, *cat.shape[1:])

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        return x.transpose(0, 1).contiguous()

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return x.amax(0, keepdim=True).expand_as(x)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.int64).sum(0, keepdim=True).expand(x.shape)

    def collect(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def barrier(self) -> None:
        pass

    def __repr__(self) -> str:
        return f"LocalMesh({self.n_dev}, {self.device})"


class GroupMesh:
    """One shard per process of a torch.distributed group (S = 1). Over
    NCCL the shards live on each process's current CUDA device (set it with
    torch.cuda.set_device, one card per process); over gloo on the CPU."""

    def __init__(self, group=None):
        self.group = group if group is not None else dist.group.WORLD
        self.n_dev = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.device = resolve_device(
            "cuda" if dist.get_backend(self.group) == "nccl" else "cpu")

    def ranks(self) -> torch.Tensor:
        return torch.tensor([self.rank], device=self.device)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % self.n_dev:
            raise ValueError(f"{x.shape[0]} rows do not split over "
                             f"{self.n_dev} ranks")
        m = x.shape[0] // self.n_dev
        return x[self.rank * m:(self.rank + 1) * m].to(self.device)[None]

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.n_dev)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, 1)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out.view(-1), x.view(-1), group=self.group)
        return out

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        out = x.to(torch.int64).clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        out = x.to(torch.int64).clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def collect(self, x: torch.Tensor) -> torch.Tensor:
        return self.all_gather(x[:, None])[0]

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def __repr__(self) -> str:
        return f"GroupMesh(rank {self.rank} of {self.n_dev}, {self.device})"


def make_mesh(n_devices: int | None = None,
              device: str | torch.device = "cuda",
              group=None) -> LocalMesh | GroupMesh:
    """The mesh the distributed operators run on.

    With a group, or once torch.distributed is initialized: a GroupMesh
    over it (one shard per process; n_devices, if given, must be its
    size). Otherwise a LocalMesh of n_devices shards on `device`, by
    default one per CUDA card (the JAX package's "every device"); a CUDA
    device without CUDA raises.
    """
    if group is not None or (dist.is_available() and dist.is_initialized()):
        mesh = GroupMesh(group)
        if n_devices is not None and n_devices != mesh.n_dev:
            raise ValueError(f"n_devices={n_devices} but the process group "
                             f"has {mesh.n_dev} ranks")
        return mesh
    dev = resolve_device(device)
    if n_devices is None:
        n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    return LocalMesh(n_devices, dev)
