"""Speed-of-light model for the radix sort on the card.

Bytes that must move per LSD pass over n keys, divided by the card's peak
HBM bandwidth:
  read keys (8 B) + payload (4 B per u32 column), write the same;
the digit-major histogram is radix * n / block words and is left out. A
fused single-kernel pass moves 2 * (8 + 4 * p) bytes per key; a split
histogram + scatter pass (the port's B1 + B3) reads the keys once more.
"""

from __future__ import annotations

import subprocess

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
