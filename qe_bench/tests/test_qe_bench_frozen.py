"""The yardstick's frozen copies (qe_bench/common/) against the program's
originals on fixed inputs. Once the program changes its own, the test
skips: the yardstick keeps its copy."""

from collections import Counter
from types import SimpleNamespace

import pytest
import torch

from qe_bench.common import sol, trace

KERNELS = ["(anonymous namespace)::histogram_kernel<8>",
           "(anonymous namespace)::scan_kernel", "void at::native::"
           "index_elementwise_kernel<128, 4>", "Memcpy DtoH (Device -> "
           "Pageable)", "void at::native::vectorized_elementwise_kernel",
           "(anonymous namespace)::rank_kernel<true>", "cub::DeviceRadixSort"
           "OnesweepKernel", "at_cuda_detail::cub::DeviceScanKernel"]


def _same_or_skip(ours, theirs, what):
    if ours != theirs:
        pytest.skip(f"the program's {what} changed; the yardstick keeps "
                    "its frozen copy")


def test_categories_and_device_time():
    from tpu_qe_torch.bench import matrix
    _same_or_skip(trace.CATEGORIES, matrix.CATEGORIES, "CATEGORIES")
    assert [trace._category(k) for k in KERNELS] == [
        matrix._category(k) for k in KERNELS]
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, dev, us):
        return SimpleNamespace(name=name, device_type=dev, time_range=
                               SimpleNamespace(elapsed_us=lambda: us))
    events = [ev(k, cuda, 10.0 * (i + 1)) for i, k in enumerate(KERNELS)]
    events += [ev("request", cpu, 500.0), ev("request", cuda, 400.0)]
    prof = SimpleNamespace(events=lambda: events)
    assert trace.device_time(prof, 1.0) == matrix.device_time(prof, 1.0)


@pytest.mark.parametrize("n,pays,key_bytes,fused", [
    (1 << 26, 1, 8, True), (1000, 0, 4, True), (12345, 3, 8, False)])
def test_sort_pass_bytes(n, pays, key_bytes, fused):
    from tpu_qe_torch.bench import sol as program
    theirs = program.sort_pass_bytes(n, pays, key_bytes, fused)
    _same_or_skip(sol.sort_pass_bytes(n, pays, key_bytes, fused), theirs,
                  "sort_pass_bytes")
    passes = Counter({(n, key_bytes, pays): 8})
    ours = sol.radix_bytes(passes) / sol.hbm_peak_bytes_per_s(
        "NVIDIA H100 80GB HBM3")
    _same_or_skip(ours, program.operator_sol_seconds(
        passes, 0, 0, "NVIDIA H100 80GB HBM3"), "operator_sol_seconds")


def test_hbm_peak():
    from tpu_qe_torch.bench import sol as program
    for name in ("NVIDIA H100 80GB HBM3", "NVIDIA H200"):
        _same_or_skip(sol.hbm_peak_bytes_per_s(name),
                      program.hbm_peak_bytes_per_s(name),
                      "hbm_peak_bytes_per_s")
    with pytest.raises(ValueError):
        sol.hbm_peak_bytes_per_s("NVIDIA A100")
