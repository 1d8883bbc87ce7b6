"""What the program's spans cost when a profiler records, and how set-up
splits between them, on the benchmark's SCF step (``benchmark/configs``).

For each executor (``filtered``: ``build_filtered_executor(..., eps).step``,
``plain``: ``build_multiply_executor``) over the configuration's operands
(A cycling through two variants, B fixed, as the benchmark's cells call
them): set-up on the host clock with the timers of the build spans
(``filtered/build``, ``executor/build``, ``executor/symbolic``,
``multiply/route``, ``filtered/prep``), then loops of ``--steps`` steps,
each ending in a synchronise, in the order off, on, on, off, off, on:
"off" with no profiler, "on" under a ``torch.profiler`` session that
records CPU activity only, so that the spans record their CUDA events and
nothing traces the device. The "on" loops also give each step span's
device time. One line of JSON an executor, with the plan's effective and
tile flops.

    python tools/torch/span_cost.py [--config PATH] [--steps N] [--seed N]
        [--executors filtered plain] [--device cuda|cpu]
"""
import argparse
import gc
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch  # noqa: E402

ORDER = ("off", "on", "on", "off", "off", "on")
SETUP_SPANS = ("filtered/build", "executor/build", "executor/symbolic", "multiply/route",
               "filtered/prep")
STEP_SPANS = ("executor/align", "filtered/norms", "filtered/mask")


def card(dev) -> dict:
    if dev.type != "cuda":
        return {"name": "cpu"}
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return {"name": torch.cuda.get_device_name(dev), "nvidia_smi": out.stdout.strip()}


def measure(cfg: dict, executor: str, steps: int, seed: int, dev) -> dict:
    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.core.timing import reset_timers, timer_stats

    from benchmark.operands import make_operands, pattern_of
    from benchmark.products import matrices

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    ops = make_operands(cfg, pattern_of(cfg), seed, 2, dev)
    sync()
    operands_s = time.perf_counter() - t0
    a, b = matrices(cfg, ops)
    reset_timers()
    t0 = time.perf_counter()
    if executor == "filtered":
        ex = dt.build_filtered_executor("N", "N", a, b, float(cfg["eps"]))
        step, fn, eff = ex.step, ex.fn, ex.eff_flops

        def call(x):
            return step(x, ops.b)[0]
    else:
        fn, _, eff = dt.build_multiply_executor("N", "N", a, b)

        def call(x):
            return fn(x, ops.b)
    out = call(ops.a[0])  # the first call, as set-up makes it
    sync()
    del out
    setup = {"build_and_first_call_s": time.perf_counter() - t0, "operands_s": operands_s}
    st = timer_stats()
    setup.update({k: st[k].total_time for k in SETUP_SPANS if k in st})

    loops = {"off": [], "on": []}
    device = {k: 0.0 for k in STEP_SPANS}
    n_on = 0
    for mode in ORDER:
        reset_timers()
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
        if mode == "on":
            prof.__enter__()
        try:
            t0 = time.perf_counter()
            for i in range(steps):
                out = call(ops.a[i % 2])
                sync()
                del out
            loops[mode].append((time.perf_counter() - t0) / steps * 1e3)
        finally:
            if mode == "on":
                prof.__exit__(None, None, None)
        if mode == "on":
            st = timer_stats()
            n_on += steps
            for k in STEP_SPANS:
                if k in st:
                    device[k] += st[k].device_time
    res = {"executor": executor, "steps": steps, "order": list(ORDER),
           "step_ms": loops, "setup": setup, "eff_flops": eff, "hw_flops": fn.plan.hw_flops,
           "device_ms_per_step": {k: v / n_on * 1e3 for k, v in device.items() if v}}
    if dev.type == "cuda":
        res["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return res


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=os.path.join(REPO, "benchmark", "configs",
                                                      "water_2048.json"))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=2**31 + 12345)
    ap.add_argument("--executors", nargs="+", default=["filtered", "plain"],
                    choices=["filtered", "plain"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from dbcsr_tpu_torch.core.machine import program_device

    import dbcsr_tpu_torch as dt

    dev = program_device(args.device)
    dt.init_lib()
    if dev.type == "cuda":
        from dbcsr_tpu_torch import _build

        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        _build.build_kernels()
    with open(args.config) as f:
        cfg = json.load(f)
    info = card(dev)
    out = []
    for ex in args.executors:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        res = dict(measure(cfg, ex, args.steps, args.seed, dev), card=info)
        print(json.dumps(res), flush=True)
        out.append(res)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
