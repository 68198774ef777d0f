"""Run one cell of the benchmark once and print its result line.

    python3 qe_bench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout. Needs a CUDA card (the cells' chips); exits
2 without one and 3 when JAX or the JAX package was loaded. The last line
of standard output is one JSON object: with --trace 0 the cell's
end-to-end metrics, with --trace 1 its per-layer metrics, read from a
profiled slice at the start of the window. The numbers that decide
`correct` are printed last on standard error, each beside its limit.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from qe_bench.common import harness
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        print(f"{cell.name} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T0)
    bad = harness.forbidden_modules()
    if bad:
        print("loaded modules of JAX or the JAX package: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    print("set-up phases, seconds since start: " + ", ".join(
        f"{k} {v:.3f}" for k, v in result["setup_phases_s"].items()),
        file=sys.stderr)
    for err in result["errors"]:
        print(f"failed request: {err}", file=sys.stderr)
    for name, check in result["checks"].items():
        bound = " ".join(f"{k} {v}" for k, v in check.items() if k != "value")
        print(f"check {name} {check['value']} {bound}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
