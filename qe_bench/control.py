"""The control of a cell: the reference in lower precision put in the
program's place, beside the program, on several seeds in one process.

    python3 qe_bench/control.py --workload <name> --seeds 11,12,13
        [--seconds 5]

For each seed one short window of the program and one of the control at
the cell's own size and load, each judged by the benchmark's comparison.
One JSON line per seed: the mismatched values of each. The control has to
read above the limit (0) on every seed, the program at it. Not part of a
benchmark run.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(workload: str, seeds: list, seconds: float,
             device: str = "cuda", cfg: dict | None = None) -> list:
    """[{seed, program, control, ...}] for each seed."""
    from qe_bench.common import harness
    cell = harness.load_cell(workload)
    if cfg:
        cell.cfg.update(cfg)
    out = []
    for seed in seeds:
        row = {"workload": workload, "seed": seed}
        for side in ("program", "control"):
            r = harness.run(cell, seed, seconds, False, device,
                            time.perf_counter(), control=side == "control")
            row[side] = r["checks"]["mismatched_values"]["value"]
            row[side + "_answers"] = r["checks"]["answers_checked"]["value"]
            row[side + "_failed"] = r["failed"]
        out.append(row)
        print(json.dumps(row), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    rows = readings(args.workload, [int(s) for s in args.seeds.split(",")],
                    args.seconds)
    ok = all(r["program"] == 0 and r["control"] > 0 for r in rows)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
