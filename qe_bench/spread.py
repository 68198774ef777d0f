"""Median and spread of the result lines of repeated runs.

    python3 qe_bench/spread.py FILE...

Each FILE holds the standard output of runs of one cell (the last JSON
line of each run is read; other lines are skipped). For every metric:
the runs' values, the median and the spread, the distance between the
first and third quartiles (statistics.quantiles(n=4)) over the median.
Not part of a benchmark run.
"""

import json
import statistics
import sys


def spread(values: list) -> float:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def lines(path: str) -> list:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("{") and '"metrics"' in line:
                out.append(json.loads(line))
    return out


def main(paths) -> int:
    for path in paths:
        runs = lines(path)
        print(f"{path}: {len(runs)} runs, correct "
              f"{sum(r['correct'] for r in runs)}")
        names = sorted({m for r in runs for m in r["metrics"]})
        for m in names:
            vals = [r["metrics"][m]["value"] for r in runs
                    if m in r["metrics"]]
            med = statistics.median(vals)
            s = spread(vals) if len(vals) >= 2 else float("nan")
            print(f"  {m}: median {med!r} spread {s:.5f} values "
                  + " ".join(repr(v) for v in vals))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
