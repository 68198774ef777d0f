"""The radix kernels' share of their roofline, %: the bytes the recorded
LSD passes had to move (each pass's keys and payloads read once and
written once, common/sol.py) at the card's peak HBM bandwidth, over the
device time of B1, B2 and B3. Bandwidth bounds it: the passes do no
arithmetic worth counting."""

from qe_bench.common.sol import radix_bytes
from qe_bench.common.trace import RADIX


def read(ctx):
    ms = sum(ctx["by_category_ms"].get(c, 0.0) for c in RADIX)
    nbytes = radix_bytes(ctx["radix_passes"])
    if ms <= 0 or not nbytes or not ctx["hbm_peak"]:
        return None
    return 100.0 * nbytes / ctx["hbm_peak"] / (ms / 1e3)
