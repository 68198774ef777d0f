"""On the card, at each cell's own size and load: the control (the
reference in lower precision in the program's place) is not correct on
three seeds, and the program beside it is. Skips without a card.

    python3 -m pytest -p no:cacheprovider qe_bench/tests -m cuda
"""

import json
import os

import pytest

from qe_bench import control
from qe_bench.common import harness

CELLS = [w["name"] for w in json.load(open(os.path.join(
    harness.ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_the_cells_size(cuda_card, workload):
    rows = control.readings(workload, [2 ** 31 + 41, 2 ** 31 + 42,
                                       2 ** 31 + 43], 5.0)
    for r in rows:
        assert r["program"] == 0 and r["program_answers"] > 0, r
        assert r["control"] > 0, r
