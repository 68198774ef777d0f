"""Out-of-core top-k: the k extreme rows of more rows than one sort holds;
the port of tpu_qe/ops/bigtopk.py.

The top k of the runs' top ks is the global top k, so:

  phase A   per run: generate rows on the device (key = keygen_hash(i),
            payload i) and keep the run's k best rows (one sort, a head);
  phase B   sort the R * k candidates, take k, verify on the device:
            winners in key order, every key == keygen_hash(payload),
            payloads distinct.

Ties break by payload (the global row index) ascending, bit-identical to
a stable sort of all rows and a head. The reference sorts by (hi, lo,
payload) with an unstable sort; the port's stable sort by (hi, lo) gives
that order, since each run is made in index order and the candidates are
concatenated in run order. `largest` sorts the bitwise complement of both
key planes. Every sort is ``sort_planes`` (B1-B3 on the card).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_qe_torch.bits import narrow, widen
from tpu_qe_torch.config import resolve_device
from tpu_qe_torch.hashing import keygen_hash
from tpu_qe_torch.sort.bigsort import _build_seconds, _fence
from tpu_qe_torch.sort.planes import sort_planes
from tpu_qe_torch.utils.profiling import span


def _run_topk(r: int, run_size: int, k: int, seed: int, largest: bool,
              device):
    """Phase A: run r's k best rows (key-ordered, ties by payload)."""
    idx = narrow(torch.arange(r * run_size, (r + 1) * run_size,
                              device=device))
    key = keygen_hash(idx, seed)
    lo, hi = key.lo, key.hi
    if largest:
        lo, hi = ~lo, ~hi        # complement: largest-first == smallest
    return _sorted_head(lo, hi, idx, k)


def _sorted_head(lo, hi, pay, k: int):
    """Best k rows of a candidate set (planes complemented when the caller
    wants largest first); ties by input order."""
    shi, slo, spay = sort_planes([hi, lo, pay], 2)
    return slo[:k], shi[:k], spay[:k]


def _verify_winners(wlo_c, whi_c, wpay, k: int, seed: int, largest: bool):
    """Winner checks: claimed order (on the planes the sort ordered),
    key == keygen_hash(payload), payloads distinct (no row picked twice).
    Returns (wlo, whi, wpay, hash_ok, order_ok, distinct_ok), the checks
    as 0-d int64 tensors."""
    lc, hc = widen(wlo_c), widen(whi_c)
    order_ok = ((hc[1:] > hc[:-1])
                | ((hc[1:] == hc[:-1]) & (lc[1:] >= lc[:-1]))).all()
    wlo, whi = (~wlo_c, ~whi_c) if largest else (wlo_c, whi_c)
    want = keygen_hash(wpay, seed)
    hash_ok = ((wlo == want.lo) & (whi == want.hi)).all()
    (p_sorted,) = sort_planes([wpay], 1)
    distinct_ok = (p_sorted[1:] != p_sorted[:-1]).all()
    return (wlo, whi, wpay, hash_ok.to(torch.int64),
            order_ok.to(torch.int64), distinct_ok.to(torch.int64))


def _combine_topk(parts, k: int, seed: int, largest: bool):
    """Phase B: the global k of the R * k candidates, verified."""
    lo, hi, pay = (torch.cat([p[i] for p in parts]) for i in range(3))
    wlo_c, whi_c, wpay = _sorted_head(lo, hi, pay, k)
    return _verify_winners(wlo_c, whi_c, wpay, k, seed, largest)


@dataclasses.dataclass(frozen=True)
class BigTopKResult:
    n: int
    k: int
    seconds: float
    rows_per_s: float
    hash_ok: bool              # every winner is a real generated row
    order_ok: bool             # winners in claimed key order
    distinct_ok: bool          # no row selected twice
    phase_a_s: float
    phase_b_s: float
    compile_s: float = 0.0

    @property
    def all_ok(self) -> bool:
        return self.hash_ok and self.order_ok and self.distinct_ok


def top_k_big(n: int, k: int, run_size: int = 1 << 26, seed: int = 7,
              largest: bool = False, verbose: bool = False,
              collect: bool = False, device: str | torch.device = "cuda"):
    """Out-of-core top-k of n rows generated on the device; on the card
    unless `device` names another.

    Returns BigTopKResult; collect=True also returns the winners' (u64
    keys, u32 payloads) numpy arrays, best first (oracle tests).
    """
    assert n % run_size == 0, (n, run_size)
    assert n < (1 << 32), "payload travels as u32 global index"
    assert 0 < k <= run_size, (k, run_size)
    n_runs = n // run_size
    assert n_runs * k < (1 << 28), \
        ("candidate set exceeds the in-core combine; recurse the "
         "combine (top-k of candidate top-ks) for k this large",
         n_runs, k)
    dev = resolve_device(device)
    compile_s = _build_seconds(dev)

    t0 = _fence(dev)
    with span("bigtopk phase A: run selection"):
        parts = [_run_topk(r, run_size, k, seed, largest, dev)
                 for r in range(n_runs)]
    t_a = _fence(dev) - t0

    t1 = _fence(dev)
    with span("bigtopk phase B: combine"):
        out = _combine_topk(parts, k, seed, largest)
        h_ok, o_ok, d_ok = torch.stack(out[3:]).tolist()
    t_b = _fence(dev) - t1
    dt = t_a + t_b
    res = BigTopKResult(
        n=n, k=k, seconds=dt, rows_per_s=n / dt, hash_ok=bool(h_ok),
        order_ok=bool(o_ok), distinct_ok=bool(d_ok),
        phase_a_s=t_a, phase_b_s=t_b, compile_s=compile_s)
    if verbose:
        print(f"bigtopk: n={n} k={k} R={n_runs} largest={largest} "
              f"A={t_a:.2f}s B={t_b:.2f}s ok={res.all_ok}")
    if collect:
        wlo, whi, wpay = (x.cpu().numpy().view(np.uint32) for x in out[:3])
        keys = (whi.astype(np.uint64) << np.uint64(32)) \
            | wlo.astype(np.uint64)
        return res, (keys, wpay)
    return res
