"""The out-of-core SQL verb battery of tools/verb_battery.py on
tpu_qe_torch: `bench-bigsql` for each of the nine verbs, in ONE process
(one CUDA context and one kernel build for all of them; each verb's bench
runs once untimed before its timed run).

    python tools/verb_battery_torch.py [--n 1073741824] [--device cuda]
        [--run-size R] [--groups G]

Prints each verb's JSON line (and `=== verb` on stderr before it); exit
code 1 if any verb's check failed. `main(argv)` returns that code. Any
other option is passed on to every `bench-bigsql` call.
"""

from __future__ import annotations

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

VERBS = ["orderby", "head", "distinct", "setops", "countdistinct",
         "join", "window", "range", "vvjoin"]


def main(argv=None) -> int:
    from tpu_qe_torch.__main__ import main as cli
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--n" not in argv:
        argv = ["--n", str(1 << 30)] + argv
    rc = 0
    for v in VERBS:
        print(f"=== {v}", file=sys.stderr, flush=True)
        rc |= cli(["bench-bigsql", "--verb", v] + argv)
    return rc


if __name__ == "__main__":
    sys.exit(main())
