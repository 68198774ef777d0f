"""sql.syncs, read in the host-paced cells, which report
rows_per_s_hostpaced."""

import os

from qe_bench.common.harness import load_module

read = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "sql.syncs.py")).read
