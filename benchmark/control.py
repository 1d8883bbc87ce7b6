"""The control of the comparison: the plain reference put in the program's
place and computed one precision below the configuration's
(``control_dtype``: float32 for float64, TF32 off), norms and keep
decisions included (each call module's ``Control``). ``correct`` has to
come out false for it; its readings are the upper end that the limit is
set under.

    python benchmark/control.py --workload <cell> --seeds 11 12 13 [--seconds 2]

runs the cell's harness once a seed in one process with the control in the
program's place, on one card (the reference is not distributed), and prints
one JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from benchmark.harness import run

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        out = run(args.workload, seed, args.seconds, False, chips=1, program="control")
        print(json.dumps({"workload": args.workload, "seed": seed, "side": "control",
                          "correct": out["correct"], "attempted": out["attempted"],
                          **out["compared"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
