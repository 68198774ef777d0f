"""Distributed out-of-core top-k over a mesh of shards: the port of
tpu_qe/ops/dbigtopk.py.

Selection composes at every level (the global top k is the top k of the
shards' top ks, each the top k of its runs' top ks), so the path is a
two-level candidate tree whose every level is bigtopk's selection
(ops/bigtopk.py::_sorted_head), and the winners pass its checks
(_verify_winners: claimed order, key == hash(payload), distinct
payloads):

  phase A   every shard selects its run r's k best rows (global row index
            d * n_local + r * run_size + lane, all local shards' indices
            in one launch sequence); R * k candidates per shard survive;
  phase B   each shard reduces its candidates to a local top k,
            all_gathers the D local winner sets (the only cross-shard
            traffic) and selects and verifies the global winners.

`largest` complements the key planes once at generation and once at the
end, so every level sorts ascending. Ties break by payload (the global
row index) ascending: a shard's candidates are concatenated in run order
and the gathered sets in rank order, which is index order, so the stable
sort of ``sort_planes`` by key gives the reference's (key, payload)
order. The global selection runs once on a LocalMesh (every shard's
gathered copy is the same), on every rank of a GroupMesh.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_qe_torch.bits import narrow
from tpu_qe_torch.hashing import keygen_hash
from tpu_qe_torch.ops.bigtopk import (BigTopKResult, _sorted_head,
                                      _verify_winners)
from tpu_qe_torch.sort.bigsort import _build_seconds, _fence
from tpu_qe_torch.sort.dbigsort import run_index
from tpu_qe_torch.utils.profiling import span


def _run_heads(mesh, n_local, r, run_size, k, seed, largest):
    """Phase A: every local shard's run r -> its k best rows, (S, k) int32
    planes (lo, hi, payload), complemented when largest."""
    idx = narrow(run_index(mesh, n_local, r, run_size, mesh.device))
    key = keygen_hash(idx, seed)
    lo, hi = (~key.lo, ~key.hi) if largest else (key.lo, key.hi)
    heads = [_sorted_head(lo[i], hi[i], idx[i], k)
             for i in range(idx.shape[0])]
    return tuple(torch.stack(c) for c in zip(*heads))


def top_k_big_distributed(n: int, k: int, mesh, run_size: int = 1 << 26,
                          seed: int = 7, largest: bool = False,
                          verbose: bool = False, collect: bool = False,
                          force_composed: bool = False):
    """Distributed out-of-core top-k of n generated rows over `mesh`
    (module docstring), on the mesh's device.

    n must be a multiple of D * run_size. The row model is top_k_big's
    (key = hash(global index), payload = the index), so the winners equal
    the single-device ones at equal n. At D == 1 the call delegates to
    top_k_big unless force_composed. Returns BigTopKResult; with
    collect=True also the winners' (u64 keys, u32 payloads), best first.
    """
    n_dev = mesh.n_dev
    dev = mesh.device
    if n_dev == 1 and not force_composed:
        from tpu_qe_torch.ops.bigtopk import top_k_big
        return top_k_big(n, k, run_size=run_size, seed=seed,
                         largest=largest, verbose=verbose, collect=collect,
                         device=dev)
    assert n % (n_dev * run_size) == 0, \
        (f"n must be a multiple of devices*run_size "
         f"(n={n}, devices={n_dev}, run_size={run_size})")
    assert n < (1 << 32), "payload travels as u32 global index"
    assert 0 < k <= run_size, (k, run_size)
    n_local = n // n_dev
    n_runs = n_local // run_size
    assert n_runs * k < (1 << 28) and n_dev * k < (1 << 28), \
        ("candidate set exceeds the in-core combine; recurse the "
         "candidate tree for k this large", n_runs, n_dev, k)
    compile_s = _build_seconds(dev)

    t0 = _fence(dev)
    with span("dbigtopk phase A: run selection"):
        parts = [_run_heads(mesh, n_local, r, run_size, k, seed, largest)
                 for r in range(n_runs)]
    t_a = _fence(dev) - t0

    t1 = _fence(dev)
    with span("dbigtopk phase B: combine"):
        lo, hi, pay = (torch.cat([p[c] for p in parts], 1) for c in range(3))
        del parts
        local = [_sorted_head(lo[i], hi[i], pay[i], k)
                 for i in range(lo.shape[0])]
        # every shard's gathered copy is the same set: select it once
        glo, ghi, gpay = (mesh.all_gather(torch.stack(c))[0]
                          for c in zip(*local))
        out = _verify_winners(*_sorted_head(glo, ghi, gpay, k), k, seed,
                              largest)
        h_ok, o_ok, d_ok = torch.stack(out[3:]).tolist()
    t_b = _fence(dev) - t1
    dt = t_a + t_b
    res = BigTopKResult(
        n=n, k=k, seconds=dt, rows_per_s=n / dt, hash_ok=bool(h_ok),
        order_ok=bool(o_ok), distinct_ok=bool(d_ok),
        phase_a_s=t_a, phase_b_s=t_b, compile_s=compile_s)
    if verbose:
        print(f"dbigtopk: n={n} k={k} D={n_dev} R={n_runs}/dev "
              f"largest={largest} A={t_a:.2f}s B={t_b:.2f}s "
              f"ok={res.all_ok}")
    if collect:
        wlo, whi, wpay = (x.cpu().numpy().view(np.uint32) for x in out[:3])
        keys = (whi.astype(np.uint64) << np.uint64(32)) \
            | wlo.astype(np.uint64)
        return res, (keys, wpay)
    return res
