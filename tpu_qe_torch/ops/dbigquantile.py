"""Distributed out-of-core exact quantiles over a mesh of shards: the port
of tpu_qe/ops/dbigquantile.py.

ops/bigquantile.py selects order statistics over one device's sorted runs
without a merge; here every shard holds its share of the runs, and each of
the 64 greedy bit rounds counts its candidates with one batched
``torch.searchsorted`` over the shard's runs and one ``psum`` over the
mesh. The greedy state is the same on every shard, so no row moves:

  interconnect = 64 rounds x one (Q,) psum

The rank certificate count_lt(v) <= r < count_le(v) (the rank and the
membership of v) is computed on the device, as on one device. Shard d's
runs cover its contiguous index range, so the data is bigquantile's at
the same n and the answers are equal.

As in the port's quantile_big: each run is sorted by ``sort_planes``
(B1-B3 on the card) over the key bits that key_bits leaves, and stored
once as its ``sort.driver.signed_key`` in a resident (S, R, run_size)
int64 tensor; candidates are int64 bit patterns of u64 values; the
reference's u32 counts are carried in int64 (n < 2^32 rows, so they are
the same numbers); nothing is read back inside the rounds. There is no
D = 1 delegation: the path always runs composed, as the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_qe_torch.ops.bigquantile import (_INT64_MIN,
                                          _make_sorted_run_keys)
from tpu_qe_torch.ops.quantile import canon_qs, disc_rank
from tpu_qe_torch.sort.bigsort import _build_seconds, _fence
from tpu_qe_torch.sort.driver import signed_key
from tpu_qe_torch.utils.profiling import span


def _counts(mesh, runs: torch.Tensor, cand: torch.Tensor, side: str):
    """Keys below (side "left") or at most (side "right") each shard's
    signed-key candidates over the whole mesh: runs (S, R, run_size),
    cand (S, Q) -> (S, Q) int64, the psum of every shard's run sums."""
    shards, n_runs, width = runs.shape
    q = cand[:, None].expand(-1, n_runs, -1).reshape(shards * n_runs, -1)
    local = torch.searchsorted(runs.reshape(-1, width), q.contiguous(),
                               side=side).reshape(shards, n_runs, -1).sum(1)
    return mesh.psum(local)


def _select(mesh, runs: torch.Tensor, ranks: tuple):
    """64 greedy bit rounds over the mesh's runs. Returns the (S, Q)
    selected values as int64 bit patterns of u64 and the (S,) rank
    certificates, on the device."""
    shards = runs.shape[0]
    r = torch.tensor(ranks, dtype=torch.int64,
                     device=runs.device).expand(shards, -1)
    p = torch.zeros_like(r)                 # u64 bits as int64
    for b in range(63, -1, -1):
        c = p | (_INT64_MIN if b == 63 else 1 << b)
        take = _counts(mesh, runs, c ^ _INT64_MIN, "left") <= r
        p = torch.where(take, c, p)
    key = p ^ _INT64_MIN
    cnt_lt = _counts(mesh, runs, key, "left")
    cnt_le = _counts(mesh, runs, key, "right")
    return p, ((cnt_lt <= r) & (r < cnt_le)).all(1)


@dataclasses.dataclass
class DistBigQuantileResult:
    n: int
    values: np.ndarray
    ranks: tuple
    cert_ok: bool
    seconds: float
    runs_s: float
    select_s: float
    rows_per_s: float
    n_runs: int           # global run count (devices x runs/dev)
    n_dev: int

    @property
    def all_ok(self) -> bool:
        return bool(self.cert_ok)


def quantile_big_distributed(n: int, qs, mesh, run_size: int = 1 << 26,
                             seed: int = 7, key_bits: int = 64,
                             verbose: bool = False,
                             ranks: tuple | None = None
                             ) -> DistBigQuantileResult:
    """Exact global PERCENTILE_DISC over n keys sharded as out-of-core
    sorted runs across the mesh (module docstring), on the mesh's device.
    `ranks` overrides the DISC rank derivation (the CONT driver below)."""
    n_dev = mesh.n_dev
    dev = mesh.device
    assert n % (n_dev * run_size) == 0, \
        (f"n must be a multiple of devices*run_size "
         f"(n={n}, devices={n_dev}, run_size={run_size})")
    runs_per_dev = n // (n_dev * run_size)
    if ranks is None:
        ranks = tuple(disc_rank(num, sh, n) for num, sh in canon_qs(qs))
    _build_seconds(dev)     # the kernels' build stays out of the timed phases
    my = mesh.ranks().tolist()

    t0 = _fence(dev)
    runs = torch.empty((len(my), runs_per_dev, run_size), dtype=torch.int64,
                       device=dev)
    with span("dbigquantile phase A: sorted runs"):
        for rr in range(runs_per_dev):
            for i, d in enumerate(my):
                # shard d's run rr is global run d * runs_per_dev + rr
                slo, shi = _make_sorted_run_keys(d * runs_per_dev + rr,
                                                 run_size, seed, key_bits,
                                                 dev)
                runs[i, rr] = signed_key(slo, shi)
                del slo, shi
    t1 = _fence(dev)
    with span("dbigquantile phase S: bit rounds"):
        p, cert = _select(mesh, runs, ranks)
        out = mesh.collect(torch.cat([p, cert[:, None].to(torch.int64)],
                                     1)).cpu().numpy()
    t2 = _fence(dev)
    values = out[0, :-1].view(np.uint64)
    cert_ok = bool(out[:, -1].all())
    if verbose:
        print(f"dbigquantile: {n_dev} dev x {runs_per_dev} runs "
              f"{t1 - t0:.2f}s, select {t2 - t1:.2f}s, "
              f"cert={'OK' if cert_ok else 'FAIL'}")
    secs = t2 - t0
    return DistBigQuantileResult(
        n=n, values=values, ranks=ranks, cert_ok=cert_ok, seconds=secs,
        runs_s=t1 - t0, select_s=t2 - t1, rows_per_s=n / secs,
        n_runs=n_dev * runs_per_dev, n_dev=n_dev)


def quantile_cont_big_distributed(n: int, qs, mesh,
                                  run_size: int = 1 << 26, seed: int = 7,
                                  key_bits: int = 64,
                                  verbose: bool = False):
    """Exact global PERCENTILE_CONT over mesh-sharded out-of-core runs: the
    floor and ceil rank pairs ride the same selection (2Q ranks, each
    certified); the fractional numerators are exact host integers.
    Returns ops/bigquantile.BigContQuantileResult."""
    from tpu_qe_torch.ops.bigquantile import BigContQuantileResult
    from tpu_qe_torch.ops.quantile import cont_rank

    spec = canon_qs(qs)
    trip = [cont_rank(num, sh, n) for num, sh in spec]
    ranks = tuple(r for f, c, _ in trip for r in (f, c))
    res = quantile_big_distributed(n, None, mesh, run_size=run_size,
                                   seed=seed, key_bits=key_bits,
                                   verbose=verbose, ranks=ranks)
    return BigContQuantileResult(
        n=n, lower=res.values[0::2], upper=res.values[1::2],
        frac_num=tuple(fr for _, _, fr in trip),
        shifts=tuple(sh for _, sh in spec), cert_ok=res.cert_ok,
        seconds=res.seconds, rows_per_s=res.rows_per_s,
        n_runs=res.n_runs)
