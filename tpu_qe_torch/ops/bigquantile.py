"""Out-of-core exact quantiles: sorted runs and a bitwise selection, with
no merge phase; the port of tpu_qe/ops/bigquantile.py.

The (r+1)-th smallest key is the largest v with count_lt(v) <= r, a
predicate monotone in v; count_lt(v) is the sum over the resident sorted
runs of one binary search each, and 64 greedy bit rounds solve the
predicate, from bit 63 down. So order statistics over 1B keys cost R run
sorts and 66 x R binary searches, never a merge:

  phase A   per run: generate the keys on the device (keygen_hash of the
            global row index, masked to key_bits) and sort them;
  phase S   64 bit rounds, then the exact rank certificate

                count_lt(v_q) <= r_q < count_le(v_q)   for every q,

            which proves the rank and that v_q is an element of the data.
            Ranks come from exact host integers (ops/quantile.disc_rank).

Differences from the reference, none of which changes a result:
- A run's sort is ``sort_planes`` over the key bits that key_bits leaves
  (B1-B3 on the card): key_bits 8 sorts in one 8-bit pass of a lone
  plane, not eight.
- After its sort each run is stored once as its ``sort.driver.signed_key``
  (an int64 whose signed order is the unsigned key order) in row r of one
  resident (R, run_size) int64 tensor, and its planes are freed. A bit
  round is then one batched ``torch.searchsorted`` of (R, Q) queries
  against that tensor, summed over the runs, where the reference searches
  each run's (lo, hi) planes (the port's searchsorted_u64 would rebuild
  the int64 key of the whole run on every call).
- Candidates are built in u64 space, as int64 bit patterns (p | 1 << b,
  bit 63 being int64's minimum), then mapped to the signed key. Nothing
  is read back inside the rounds: values, counts and the certificate
  cross to the host once, at the end.

Phases are fenced with torch.cuda.synchronize(); `seconds` excludes the
kernels' build at first use.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_qe_torch.bits import masked_key, narrow
from tpu_qe_torch.config import resolve_device
from tpu_qe_torch.hashing import keygen_hash
from tpu_qe_torch.ops.quantile import canon_qs, cont_rank, disc_rank
from tpu_qe_torch.sort.bigsort import _build_seconds, _fence
from tpu_qe_torch.sort.driver import signed_key
from tpu_qe_torch.sort.planes import sort_planes
from tpu_qe_torch.utils.profiling import span

_INT64_MIN = torch.iinfo(torch.int64).min     # bit 63; also the sign flip


def _make_sorted_run_keys(r: int, n_run: int, seed: int, key_bits: int,
                          device):
    """Run r's keys (keys only: the selection carries no payload), sorted,
    as (lo, hi) int32 planes. key_bits < 64 masks the keys, which makes
    duplicate-heavy data (tests); 64 is the bigsort data model."""
    idx = narrow(torch.arange(r * n_run, (r + 1) * n_run, device=device))
    lo, hi = masked_key(*keygen_hash(idx, seed), key_bits)
    if key_bits <= 32:
        (slo,) = sort_planes([lo], 1, key_bits=[key_bits])
        return slo, hi
    shi, slo = sort_planes([hi, lo], 2, key_bits=[min(key_bits - 32, 32),
                                                   32])
    return slo, shi


def _counts(runs: torch.Tensor, cand: torch.Tensor, side: str):
    """Keys below (side "left") or at most (side "right") each signed-key
    candidate, summed over the (R, run_size) runs: (Q,) int64."""
    q = cand.expand(runs.shape[0], -1).contiguous()
    return torch.searchsorted(runs, q, side=side).sum(0)


def _select_from_runs(runs: torch.Tensor, ranks: tuple):
    """64 greedy bit rounds over the resident runs (the signed keys of the
    sorted runs, one row each). Returns the (Q,) selected values as int64
    bit patterns of u64, the certificate (0-d bool) and cnt_lt, cnt_le
    ((Q,) int64), all on the device."""
    r = torch.tensor(ranks, dtype=torch.int64, device=runs.device)
    p = torch.zeros_like(r)                 # u64 bits as int64
    for b in range(63, -1, -1):
        c = p | (_INT64_MIN if b == 63 else 1 << b)
        take = _counts(runs, c ^ _INT64_MIN, "left") <= r
        p = torch.where(take, c, p)
    key = p ^ _INT64_MIN
    cnt_lt = _counts(runs, key, "left")
    cnt_le = _counts(runs, key, "right")
    cert = ((cnt_lt <= r) & (r < cnt_le)).all()
    return p, cert, cnt_lt, cnt_le


@dataclasses.dataclass
class BigQuantileResult:
    n: int
    values: np.ndarray        # (Q,) u64: exact PERCENTILE_DISC elements
    ranks: tuple              # 0-based target ranks
    cert_ok: bool             # the rank certificate, computed on the device
    seconds: float            # runs + selection (the build excluded)
    runs_s: float
    select_s: float
    rows_per_s: float
    n_runs: int

    @property
    def all_ok(self) -> bool:
        return bool(self.cert_ok)


def quantile_big(n: int, qs, run_size: int = 1 << 26, seed: int = 7,
                 key_bits: int = 64, verbose: bool = False,
                 ranks: tuple | None = None,
                 device: str | torch.device = "cuda") -> BigQuantileResult:
    """Exact global PERCENTILE_DISC over n keys generated on the device,
    more than one in-core sort holds (module docstring); on the card
    unless `device` names another.

    ranks: explicit 0-based order-statistic ranks in place of the
    PERCENTILE_DISC ranks of qs (the CONT driver below selects floor /
    ceil rank pairs this way)."""
    assert n % run_size == 0, (n, run_size)
    n_runs = n // run_size
    if ranks is None:
        ranks = tuple(disc_rank(num, sh, n) for num, sh in canon_qs(qs))
    dev = resolve_device(device)
    _build_seconds(dev)     # the kernels' build stays out of the timed phases

    t0 = _fence(dev)
    runs = torch.empty((n_runs, run_size), dtype=torch.int64, device=dev)
    with span("bigquantile phase A: sorted runs"):
        for r in range(n_runs):
            slo, shi = _make_sorted_run_keys(r, run_size, seed, key_bits,
                                             dev)
            runs[r] = signed_key(slo, shi)
            del slo, shi
    t1 = _fence(dev)
    with span("bigquantile phase S: bit rounds"):
        p, cert, cnt_lt, cnt_le = _select_from_runs(runs, ranks)
        out = torch.cat([p, cnt_lt, cnt_le, cert.view(1).to(torch.int64)]
                        ).cpu().numpy()
    t2 = _fence(dev)
    q = len(ranks)
    values, cert_ok = out[:q].view(np.uint64), bool(out[-1])
    out = out[q:-1].reshape(2, q)
    if verbose:
        print(f"bigquantile: {n_runs} runs {t1 - t0:.2f}s, "
              f"select {t2 - t1:.2f}s, cert={'OK' if cert_ok else 'FAIL'} "
              f"lt={out[0]} le={out[1]}")
    secs = t2 - t0
    return BigQuantileResult(
        n=n, values=values, ranks=ranks, cert_ok=cert_ok, seconds=secs,
        runs_s=t1 - t0, select_s=t2 - t1, rows_per_s=n / secs,
        n_runs=n_runs)


@dataclasses.dataclass
class BigContQuantileResult:
    """Exact rational PERCENTILE_CONT over out-of-core keys: the SQL answer
    per q is lower + (upper - lower) * frac_num / 2^shift (u64 keys: the
    exact fields are the result; see ops/quantile.py)."""
    n: int
    lower: np.ndarray         # (Q,) u64
    upper: np.ndarray
    frac_num: tuple
    shifts: tuple
    cert_ok: bool
    seconds: float
    rows_per_s: float
    n_runs: int

    @property
    def all_ok(self) -> bool:
        return bool(self.cert_ok)


def quantile_cont_big(n: int, qs, run_size: int = 1 << 26, seed: int = 7,
                      key_bits: int = 64, verbose: bool = False,
                      device: str | torch.device = "cuda"
                      ) -> BigContQuantileResult:
    """Exact global PERCENTILE_CONT over n keys generated on the device:
    the floor and ceil rank elements of every q go through one selection
    (2Q ranks), each with its rank certificate; the fractional numerators
    are exact host integers."""
    spec = canon_qs(qs)
    trip = [cont_rank(num, sh, n) for num, sh in spec]
    ranks = tuple(r for f, c, _ in trip for r in (f, c))
    res = quantile_big(n, None, run_size=run_size, seed=seed,
                       key_bits=key_bits, verbose=verbose, ranks=ranks,
                       device=device)
    return BigContQuantileResult(
        n=n, lower=res.values[0::2], upper=res.values[1::2],
        frac_num=tuple(fr for _, _, fr in trip),
        shifts=tuple(sh for _, sh in spec), cert_ok=res.cert_ok,
        seconds=res.seconds, rows_per_s=res.rows_per_s,
        n_runs=res.n_runs)
