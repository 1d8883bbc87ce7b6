"""One run of one cell: set-up, the measured window, the per-layer
reading of a traced window, and the judgement against the plain reference.
The harness only dispatches: the configuration's pattern kind makes the
operands (``operands.py``), the traffic mix's call module gives the
program's call, its judge and its control (``products.py``), and each
metric's reader reads the run (``metrics/``).

A cell on one chip runs in this process. A cell whose configuration names a
process grid runs one spawned process a card, over ``torch.distributed``
(NCCL on cards, gloo on the CPU), with a rendezvous file under ``TMPDIR``;
every process drives the same call each step, process 0 says when the
window ends, and each process judges its own output. End-to-end metrics
take the slowest (largest) process, per-layer metrics process 0's.

Every call is a closed loop with one caller: it ends in a synchronise, and
the next starts after it, as an SCF loop reads each product before the
next multiply.
"""
from __future__ import annotations

import gc
import json
import math
import os
import shutil
import sys
import tempfile
import time
import traceback
from contextlib import contextmanager
from dataclasses import dataclass, field
from functools import cached_property
from typing import Dict, List, Optional

import numpy as np

from . import spec

#: the most seconds that the processes of a spawned cell may take
SPAWN_DEADLINE_S = 330
#: top-level module names that no process of a run may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "dbcsr_tpu")


class NoDevice(RuntimeError):
    """The cards the cell asks for are not there."""


@dataclass
class Job:
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str  # "cuda" or, in tests only, "cpu"
    here: str
    start_wall: float
    fault: Optional[str] = None
    program: str = "program"  # or "control": the reference in its place
    pid: int = 0
    nprocs: int = 1
    url: Optional[str] = None
    rundir: Optional[str] = None


@dataclass
class Context:
    """What a metric's reader reads (``metrics/<name>.py``)."""

    job: Job
    kind: str  # the device's name
    chips: int
    pattern: object
    setup_s: float
    calls: int
    elapsed_s: float
    call_s: List[float]
    peak_bytes: int
    trace: Optional[object] = None  # trace.Trace of a traced window
    timers: Dict[str, tuple] = field(default_factory=dict)  # name -> (calls, s)
    counters: Dict[str, float] = field(default_factory=dict)

    @cached_property
    def work(self):
        from .workcount import product_work

        return product_work(self.pattern, self.job.config["dtype"])


def forbidden_modules() -> List[str]:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

def _call(job: Job):
    """The traffic mix's call module (``calls/<call>.py``)."""
    return spec.module("calls", job.traffic["call"], job.here)


def _program(job: Job, ops, grid):
    call = _call(job)
    if job.program == "control":
        return call.Control(job.config, ops)
    return call.Program(job.config, ops, grid)


def _planted(job: Job, program):
    """The program's call with ``job.fault`` planted under it (tests)."""
    if job.fault is None:
        return program
    if job.fault == "exchange":
        from dbcsr_tpu_torch.dist import comm

        def no_exchange(messages, payload):
            import torch

            me = comm.rank()
            return {i: torch.zeros(shape, dtype=dt, device=comm.device())
                    for i, (s, d, shape, dt) in enumerate(messages)
                    if d == me and s != me}

        comm.exchange = no_exchange
        return program
    state = {}

    def call(a_data):
        if job.fault == "stale":
            if "out" not in state:
                state["out"] = program(a_data)
            return state["out"]
        if job.fault == "half":
            a_data = a_data.clone()
            a_data[a_data.shape[0] // 2:] = 0
            return program(a_data)
        out = program(a_data)
        program.output(out)[1].view(-1)[0] += 1.0  # "altered"
        return out

    call.output, call.release = program.output, program.release
    return call


def make_grid(cfg: dict, device):
    """The configuration's process grid: one rank a process (and a card)
    in a multi-process run."""
    from dbcsr_tpu_torch.dist import ProcessGrid

    shape = cfg.get("grid")
    if not shape:
        return None
    n = int(np.prod(shape))
    devices: Optional[list] = [device] * n if device.type == "cpu" else None
    return ProcessGrid.make(*shape, devices=devices)


def run_process(job: Job) -> dict:
    import torch

    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.core.timing import reset_timers, timer_stats

    from .operands import make_operands, pattern_of

    distributed = job.nprocs > 1
    if distributed:
        dt.init_lib(distributed=True, coordinator_address=job.url,
                    num_processes=job.nprocs, process_id=job.pid,
                    backend="nccl" if job.device == "cuda" else "gloo",
                    device=f"cuda:{job.pid}" if job.device == "cuda" else "cpu")
        from dbcsr_tpu_torch.dist import comm

        dev = comm.device()
    else:
        dt.init_lib()
        dev = torch.device("cuda", 0) if job.device == "cuda" else torch.device(job.device)
    cuda = dev.type == "cuda"
    if cuda:
        from dbcsr_tpu_torch import _build

        torch.cuda.set_device(dev)
        _build.build_kernels()

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    variants = int(job.traffic["variants"])
    pattern = pattern_of(job.config, job.here)
    ops = make_operands(job.config, pattern, job.seed, variants, dev)
    grid = make_grid(job.config, dev) if distributed else None
    program = _planted(job, _program(job, ops, grid))
    out = program(ops.a[0])  # set-up: one call, every shape the window uses
    sync()
    del out
    if distributed:
        comm.barrier()
    setup_s = time.time() - job.start_wall

    # One output of each variant is judged: call v + V·r_v, r_v drawn from
    # the seed over the calls of that variant that the window holds (in an
    # untimed window, as many as the first call's time leaves room for),
    # and the window runs until each has come. A step that leaves its state
    # unchanged fails all but one of them. The judged store is copied to
    # host memory under "bench.keep", a pause that the window's clock and
    # the trace leave out, so the device holds one output at a time.
    rng = np.random.default_rng([job.seed, 7])
    picks: Dict[int, int] = {}
    kept: Dict[int, tuple] = {}
    paused = [0.0]
    flag = torch.zeros(1, device=dev)

    def draw(per_variant: int) -> None:
        if distributed:  # process 0's count, so that every process picks alike
            flag.fill_(float(per_variant))
            torch.distributed.broadcast(flag, 0)
            per_variant = int(flag.item())
        for v in range(variants):
            picks[v + variants * int(rng.integers(0, max(1, per_variant)))] = v

    def keep(i: int, out, rf) -> None:
        t = time.perf_counter()
        with rf("bench.keep"):
            blocks, store = program.output(out)
            kept[picks[i]] = (blocks, store.to("cpu"))
        paused[0] += time.perf_counter() - t

    def stop(elapsed: float, calls: int) -> bool:
        done = elapsed >= job.seconds and calls > max(picks)
        if not distributed:
            return done
        flag.fill_(1.0 if done else 0.0)
        torch.distributed.broadcast(flag, 0)
        return bool(flag.item())

    def one(i: int, rf) -> None:
        """Call ``i`` of the window."""
        s = time.perf_counter()
        with rf("bench.call"):
            out = program(ops.a[i % variants])
        with rf("bench.sync"):
            sync()
        e = time.perf_counter()
        call_s.append(e - s)
        if not picks:
            draw(int(job.seconds / max(e - s, 1e-6) / variants))
        if i in picks:
            keep(i, out, rf)

    call_s: List[float] = []
    trace = None
    timers: Dict[str, tuple] = {}
    counters: Dict[str, float] = {}
    if job.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from .trace import WINDOW, read_chrome

        reset_timers()
        if distributed:
            comm.reset_transfer_counts()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        n = max(int(job.traffic["trace_calls"]), variants)
        draw(n // variants)
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                t0 = time.perf_counter()
                for i in range(n):
                    one(i, record_function)
                elapsed = time.perf_counter() - t0 - paused[0]
        path = os.path.join(job.rundir or tempfile.gettempdir(),
                            f"bench-trace-{os.getpid()}.json")
        try:
            prof.export_chrome_trace(path)
            trace = read_chrome(path)
        finally:
            if os.path.exists(path):
                os.remove(path)
        timers = {k: (st.calls, st.total_time) for k, st in timer_stats().items()}
        if distributed:
            tc = comm.transfer_counts()
            counters = {"messages": tc.messages, "bytes_sent": tc.bytes_sent,
                        "bytes_received": tc.bytes_received}
    else:
        i = 0
        t0 = time.perf_counter()
        while True:
            one(i, _untraced)
            i += 1
            elapsed = time.perf_counter() - t0 - paused[0]
            if stop(elapsed, i):
                break
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"

    ctx = Context(job=job, kind=kind, chips=job.nprocs, pattern=pattern.blocks,
                  setup_s=setup_s, calls=len(call_s), elapsed_s=elapsed, call_s=call_s,
                  peak_bytes=peak, trace=trace, timers=timers, counters=counters)
    res = {"kind": kind, "calls": len(call_s), "peak_bytes": peak, "setup_s": setup_s}
    res["metrics"] = read_metrics(ctx, "per_layer" if job.trace else "end_to_end")
    if trace is not None:
        from .trace import busy_s, idle_gaps, top_ops

        res["busy_s"], res["window_s"] = busy_s(trace), trace.window_s
        res["breakdown"] = {"device_ops": top_ops(trace), "idle_gaps": idle_gaps(trace)}

    # the judgement: the program's state freed first
    outs = sorted(kept.items())
    program.release()
    del program, kept
    if distributed:
        comm.barrier()
        dt.finalize_lib()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    err = _call(job).judge(job.config, ops)
    res["compared"] = [err(ops.a[v], blocks, store.to(dev)) for v, (blocks, store) in outs]
    res["judge_s"] = time.perf_counter() - t
    res["forbidden"] = forbidden_modules()
    return res


@contextmanager
def _untraced(name: str):
    yield


def read_metrics(ctx: Context, kind: str) -> Dict[str, float]:
    out = {}
    for m in ctx.job.cell["metrics"][kind]:
        v = spec.reader(m["name"], ctx.job.here)(ctx)
        if v is not None:
            out[m["name"]] = float(v)
    return out


# ---------------------------------------------------------------------------
# spawned processes
# ---------------------------------------------------------------------------

def _worker(pid: int, job: Job) -> None:
    job.pid = pid
    try:
        res = run_process(job)
    except BaseException:
        with open(os.path.join(job.rundir, f"error_{pid}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    with open(os.path.join(job.rundir, f"result_{pid}.json"), "w") as f:
        json.dump(res, f)


def run_spawned(job: Job) -> List[dict]:
    import torch.multiprocessing as tmp

    if job.device == "cuda":  # build once, before the processes start
        from dbcsr_tpu_torch import _build, native

        _build.build_kernels()
        native._load()
    job.rundir = tempfile.mkdtemp(prefix="bench-run-")
    job.url = "file://" + os.path.join(job.rundir, "rendezvous")
    ctx = tmp.start_processes(_worker, args=(job,), nprocs=job.nprocs, join=False,
                              start_method="spawn")
    deadline = time.perf_counter() + SPAWN_DEADLINE_S
    try:
        while not ctx.join(timeout=5.0):
            if time.perf_counter() > deadline:
                raise RuntimeError(f"the processes did not end within {SPAWN_DEADLINE_S} s")
        out = []
        for pid in range(job.nprocs):
            with open(os.path.join(job.rundir, f"result_{pid}.json")) as f:
                out.append(json.load(f))
        return out
    except Exception as e:
        errs = [open(os.path.join(job.rundir, n)).read()
                for n in sorted(os.listdir(job.rundir)) if n.startswith("error_")]
        raise RuntimeError(f"{e}\n" + "\n".join(errs)) from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
        shutil.rmtree(job.rundir, ignore_errors=True)


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------

def run(name: str, seed: int, seconds: float, trace: bool, *, root: str = spec.ROOT,
        here: str = spec.HERE, device: Optional[str] = None, fault: Optional[str] = None,
        program: str = "program", start_wall: Optional[float] = None,
        chips: Optional[int] = None) -> dict:
    """The result line of one run of cell ``name``. ``device`` (tests only)
    runs on the CPU with the program's plain kernels; without it the cell's
    cards have to be there."""
    import torch

    start_wall = time.time() if start_wall is None else start_wall
    bench = spec.benchmark(root)
    cell = dict(spec.workload(bench, name))
    cell["metrics"] = {k: spec.metrics_of(bench, name, k) for k in ("end_to_end", "per_layer")}
    cfg = spec.config(cell["config"], here)
    mix = spec.traffic(cell["traffic"], here)
    chips = int(cell["chips"]) if chips is None else chips
    if device is None:
        if not torch.cuda.is_available():
            raise NoDevice("no CUDA device")
        if torch.cuda.device_count() < chips:
            raise NoDevice(f"{torch.cuda.device_count()} CUDA devices, the cell needs {chips}")
        device = "cuda"
    job = Job(cell=cell, config=cfg, traffic=mix, seed=int(seed), seconds=float(seconds),
              trace=bool(trace), device=device, here=here, start_wall=start_wall,
              fault=fault, program=program, nprocs=chips)
    procs = run_spawned(job) if chips > 1 else [run_process(job)]
    return result(job, procs)


def result(job: Job, procs: List[dict]) -> dict:
    first = procs[0]
    name = _call(job).COMPARED
    limit = float(job.config["limits"][name])
    errs = [e for p in procs for e in p["compared"]]
    worst = max(errs) if errs else math.inf
    failed = sum(1 for e in errs if not e <= limit)
    kind = "per_layer" if job.trace else "end_to_end"
    metrics = {}
    for m in job.cell["metrics"][kind]:
        key = m["name"]
        if kind == "end_to_end":  # the slowest (largest) process
            vals = [p["metrics"][key] for p in procs if key in p["metrics"]]
        else:  # process 0's
            vals = [first["metrics"][key]] if key in first["metrics"] else []
        if vals:
            metrics[key] = {"value": max(vals), "unit": m["unit"]}
    device = {"platform": "gpu" if job.device == "cuda" else job.device,
              "kind": first["kind"], "count": job.nprocs,
              "memory_peak_bytes": max(p["peak_bytes"] for p in procs)}
    out = {"correct": bool(errs) and failed == 0, "attempted": first["calls"],
           "failed": failed, "metrics": metrics, "device": device}
    if job.trace and "busy_s" in first:
        device["busy_s"] = float(np.mean([p["busy_s"] for p in procs]))
        device["window_s"] = float(np.mean([p["window_s"] for p in procs]))
        out["breakdown"] = first["breakdown"]
    out["forbidden"] = sorted({m for p in procs for m in p["forbidden"]})
    out["judge_s"] = max(p["judge_s"] for p in procs)
    out["compared"] = {name: {"value": worst if math.isfinite(worst) else "inf",
                              "limit": limit}}
    return out
