"""Speed-of-light model for the radix sort and the operators on the card.

Bytes that must move per LSD pass over n keys, divided by the card's peak
HBM bandwidth:
  read keys (8 B) + payload (4 B per u32 column), write the same;
the digit-major histogram is radix * n / block words and is left out. A
fused single-kernel pass moves 2 * (8 + 4 * p) bytes per key; a split
histogram + scatter pass (the port's B1 + B3) reads the keys once more.

An operator's envelope (``operator_sol_seconds``) is the bytes of the
radix passes its sorts ran, each pass moving its key words (4 B for a lone
plane, else 8) and its payloads (for ``sort_planes``, the 4-byte row
permutation) in and out, plus its scans, each reading and writing one
4-byte plane per row. Gathers are left out. It is the port's own model on
the card's bandwidth, not the JAX package's TPU sort model.
"""

from __future__ import annotations

import subprocess
from collections import Counter

import torch

# Peak HBM bandwidth, bytes/s, by a substring of torch.cuda.get_device_name()
# (NVIDIA data sheets: H100 SXM5 80 GB HBM3, H200 SXM 141 GB HBM3e).
_HBM_PEAK = {
    "H100 80GB HBM3": 3.35e12,
    "H200": 4.8e12,
}


def hbm_peak_bytes_per_s(device_name: str | None = None) -> float:
    """Peak HBM bytes/s of the named card (default: CUDA device 0).
    An unknown card raises."""
    name = device_name or torch.cuda.get_device_name(0)
    for key, peak in _HBM_PEAK.items():
        if key in name:
            return peak
    raise ValueError(f"no HBM peak known for {name!r}; add it to "
                     "tpu_qe_torch/bench/sol.py from the card's data sheet")


def sort_pass_bytes(n: int, payload_cols: int = 1, key_bytes: int = 8,
                    fused: bool = True) -> int:
    per_elem = key_bytes + 4 * payload_cols
    reads = per_elem if fused else per_elem + key_bytes
    return n * (reads + per_elem)


def sort_sol_seconds(n: int, num_passes: int, payload_cols: int = 1,
                     key_bytes: int = 8, fused: bool = True,
                     device_name: str | None = None) -> float:
    return (num_passes * sort_pass_bytes(n, payload_cols, key_bytes, fused)
            / hbm_peak_bytes_per_s(device_name))


def scan_bytes(n: int, planes: int) -> int:
    """Bytes of `planes` scans over n rows: one 4-byte plane read and one
    written per row each."""
    return 8 * n * planes


def operator_sol_seconds(radix_passes, scans: int, n_scan: int,
                         device_name: str | None = None) -> float:
    """Envelope of an operator: `radix_passes` maps (rows, key bytes,
    payload planes) to the LSD passes its radix sorts ran, as
    sort.driver.RADIX_PASSES records them; `scans` is the number of
    one-plane scans over `n_scan` rows."""
    total = sum(passes * sort_pass_bytes(rows, pays, key_bytes)
                for (rows, key_bytes, pays), passes in radix_passes.items())
    total += scan_bytes(n_scan, scans)
    return total / hbm_peak_bytes_per_s(device_name)


def card() -> dict:
    """Name and power limit of CUDA device 0, as nvidia-smi reports them."""
    info = {"name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "power_limit": "not measured"}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return info
    if out.returncode == 0 and "," in out.stdout:
        info["power_limit"] = out.stdout.strip().split(",")[-1].strip()
    return info


def bigsort_sol_seconds(n: int, run_size: int, n_buckets: int,
                        payload_cols: int = 1, strategy: str = "partition",
                        device_name: str | None = None) -> float:
    """Envelope of the out-of-core sort (sort/bigsort.py) at ideal bucket
    balance: the bytes of its radix passes (each carrying the row
    permutation, as ``sort_planes`` runs them) plus generating every row's
    8 + 4 * payload_cols bytes once and reading them once for the
    certificates. partition: one bucket-id pass per run (a 4-byte key of
    up to 8 bits), then 8 passes per bucket; merge: 8 passes per run and
    again per bucket. Gathers and capacity padding are left out."""
    from tpu_qe_torch.bits import digit_schedule
    from tpu_qe_torch.constants import BITS_PER_PASS
    n_runs = max(n // run_size, 1)
    m_bucket = max(n // max(n_buckets, 1), 1)
    if strategy == "partition":
        bid_bits = max(1, (n_buckets - 1).bit_length())
        runs = {(run_size, 4, 1): n_runs * len(digit_schedule(
            bid_bits, BITS_PER_PASS))}
    else:
        runs = {(run_size, 8, 1): n_runs * 8}
    rows = 2 * n * (8 + 4 * payload_cols)
    return (operator_sol_seconds(runs, 0, 0, device_name)
            + operator_sol_seconds({(m_bucket, 8, 1): n_buckets * 8}, 0, 0,
                                   device_name)
            + rows / hbm_peak_bytes_per_s(device_name))


def _radix_seconds(passes, device_name) -> float:
    return operator_sol_seconds(passes, 0, 0, device_name)


def _rows_seconds(nbytes: int, device_name) -> float:
    return nbytes / hbm_peak_bytes_per_s(device_name)


def bigagg_sol_seconds(n: int, run_size: int, n_groups: int,
                       value_cols: int = 1, minmax: bool = False,
                       device_name: str | None = None) -> float:
    """Envelope of the out-of-core GROUP BY (ops/bigagg.py) in the port's
    terms: per run, the 8 passes of the (hi, lo) group-key sort (12 with
    minmax: the value is a sort key too, and the lone hi plane takes 4
    passes of 4-byte keys), each carrying the row permutation; the
    combine's 8 passes over R * min(G, run_size) table rows; 2 one-plane
    scans per u64 or int64 prefix sum (each sum column and the compaction,
    in the runs and the combine; 2 more segmented scans in the combine with
    minmax); and each row's group id and value columns written once.
    Gathers are left out."""
    n_runs = max(n // run_size, 1)
    m = n_runs * min(n_groups, run_size)
    passes = Counter()
    passes[(run_size, 8, 1)] += 8 * n_runs
    passes[(m, 8, 1)] += 8
    if minmax:
        passes[(run_size, 4, 1)] += 4 * n_runs
    scans = 2 * value_cols + 2
    return (_radix_seconds(passes, device_name)
            + (scan_bytes(n, scans)
               + scan_bytes(m, scans + (2 if minmax else 0)))
            / hbm_peak_bytes_per_s(device_name)
            + _rows_seconds(n * 4 * (1 + value_cols), device_name))


def bigjoin_sol_seconds(n_l: int, n_r: int, n_buckets: int,
                        samples_per_side: int = 8192,
                        device_name: str | None = None) -> float:
    """Envelope of the out-of-core FK join (ops/bigjoin.py) in the port's
    terms, at ideal bucket balance: 8 passes per side sort and over the
    plan's 2 * samples_per_side samples, 8 per bucket over its n_l + n_r /
    B rows (join_fk_scan's combined key sort), each carrying the row
    permutation; the two int64 running maxima of each bucket's fill (4
    one-plane scans a row); generating the left side's 12 bytes a row and
    the right side's 8 once."""
    b = max(n_buckets, 1)
    passes = Counter()
    for rows in (n_l, n_r, 2 * samples_per_side):
        passes[(rows, 8, 1)] += 8
    passes[(max((n_l + n_r) // b, 1), 8, 1)] += 8 * b
    return (_radix_seconds(passes, device_name)
            + scan_bytes(n_l + n_r, 4) / hbm_peak_bytes_per_s(device_name)
            + _rows_seconds(12 * n_l + 8 * n_r, device_name))


def bigpipe_sol_seconds(n_l: int, n_r: int, n_buckets: int, n_groups: int,
                        samples_per_side: int = 8192,
                        device_name: str | None = None) -> float:
    """Envelope of the fused join -> GROUP BY (ops/bigpipe.py): the join's,
    plus per bucket the partial GROUP BY over its n_l / B left rows (8
    passes of the group key and 1 of the 1-bit valid flag, a lone plane;
    the sum's and the compaction's prefix sums, 4 one-plane scans a row)
    and the combine's 8 passes over B * min(G, n_l / B) table rows."""
    b = max(n_buckets, 1)
    rows = max(n_l // b, 1)
    m = b * min(n_groups, rows)
    passes = Counter()
    passes[(rows, 8, 1)] += 8 * b
    passes[(rows, 4, 1)] += b
    passes[(m, 8, 1)] += 8
    return (bigjoin_sol_seconds(n_l, n_r, n_buckets, samples_per_side,
                                device_name)
            + _radix_seconds(passes, device_name)
            + scan_bytes(n_l, 4) / hbm_peak_bytes_per_s(device_name))


def bigwindow_sol_seconds(n: int, run_size: int, n_buckets: int,
                          samples_per_run: int = 4096,
                          device_name: str | None = None) -> float:
    """Envelope of the out-of-core window (ops/bigwindow.py) in the port's
    terms, at ideal bucket balance: per run and per bucket the 12 passes of
    the stable (key hi, key lo, order) sort (8 of the (lo, order) pair and
    4 of the lone hi plane), each carrying the row permutation; the plan's
    16 passes over R * samples_per_run samples; the window sweeps' int64
    running maxima (partition and order-run starts) and running sum, 6
    one-plane scans a row; and every row's 20 bytes (key lo and hi, order,
    index, value) generated once. Gathers are left out."""
    n_runs = max(n // run_size, 1)
    b = max(n_buckets, 1)
    m = max(n // b, 1)
    passes = Counter()
    for rows, sorts in ((run_size, n_runs), (m, b)):
        passes[(rows, 8, 1)] += 8 * sorts
        passes[(rows, 4, 1)] += 4 * sorts
    passes[(n_runs * samples_per_run, 8, 1)] += 16
    return (_radix_seconds(passes, device_name)
            + scan_bytes(n, 6) / hbm_peak_bytes_per_s(device_name)
            + _rows_seconds(20 * n, device_name))
