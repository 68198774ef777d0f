"""Tests of the benchmark harness: CPU tests at tiny sizes, and tests
marked `cuda` that need the card and skip without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


# Tiny sizes of each configuration's kind for the CPU.
TINY = {"tpch": {"scale_factor": 0.002},
        "morton": {"num_vertices": 3000, "num_triangles": 9000}}


@pytest.fixture
def tiny_cell():
    """load(workload) -> the cell at a tiny size on the CPU."""
    from qe_bench.common import harness

    def load(workload):
        cell = harness.load_cell(workload)
        cell.cfg.update(TINY[cell.cfg["kind"]])
        return cell
    return load


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
