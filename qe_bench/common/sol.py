"""The yardstick's speed-of-light numbers, frozen here so that a change to
the program cannot move them.

Copied from tpu_qe_torch/bench/sol.py: the card's peak HBM bandwidth
(NVIDIA data sheets) and the bytes one LSD radix pass has to move.
"""

from __future__ import annotations

# Peak HBM bandwidth, bytes/s, by a substring of torch.cuda.get_device_name()
# (NVIDIA data sheets: H100 SXM5 80 GB HBM3, H200 SXM 141 GB HBM3e).
_HBM_PEAK = {
    "H100 80GB HBM3": 3.35e12,
    "H200": 4.8e12,
}


def hbm_peak_bytes_per_s(device_name: str) -> float:
    """Peak HBM bytes/s of the named card. An unknown card raises."""
    for key, peak in _HBM_PEAK.items():
        if key in device_name:
            return peak
    raise ValueError(f"no HBM peak known for {device_name!r}")


def sort_pass_bytes(n: int, payload_cols: int = 1, key_bytes: int = 8,
                    fused: bool = True) -> int:
    """Bytes one LSD pass over n keys moves: each key's words and payloads
    read once and written once (``fused``), or the keys read once more
    (a split histogram + scatter pass)."""
    per_elem = key_bytes + 4 * payload_cols
    reads = per_elem if fused else per_elem + key_bytes
    return n * (reads + per_elem)


def radix_bytes(passes) -> int:
    """Bytes the recorded passes had to move: `passes` maps (rows, key
    bytes, payload planes) to a number of passes, as the program's sort
    driver records them."""
    return sum(k * sort_pass_bytes(rows, pays, key_bytes)
               for (rows, key_bytes, pays), k in passes.items())
