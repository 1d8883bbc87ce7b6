"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace 0|1

Set-up (build, operands from ``--seed``, the cell's executor and its
first call) counts as ``setup_s``; then the window: ``--seconds`` of
calls with ``--trace 0`` (the cell's end-to-end metrics), or the traffic
mix's ``trace_calls`` calls under ``torch.profiler`` with ``--trace 1`` (its
per-layer metrics, ``busy_s``, ``window_s`` and a ``breakdown``). Then a
sample of the window's outputs is judged against the plain reference. The
last line of standard output is the result; the last lines of standard
error give each number compared beside its limit. Without the cell's CUDA
cards, or with a JAX module loaded, it exits 1 and prints no result.
"""
import time

START_WALL = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    os.environ.setdefault("USE_FLAX", "0")
    from benchmark.harness import NoDevice, forbidden_modules, run

    try:
        out = run(args.workload, args.seed, args.seconds, bool(args.trace),
                  start_wall=START_WALL)
    except NoDevice as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 1
    found = sorted(set(out.pop("forbidden")) | set(forbidden_modules()))
    if found:
        print(f"benchmark: modules loaded that the run may not hold: {found}",
              file=sys.stderr)
        return 1
    print(f"judge_s {out.pop('judge_s'):.3f}", file=sys.stderr)
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
