"""Call-stack timers with profiler ranges.

Port of ``dbcsr_tpu/core/timing.py``: ``timeset``/``timestop`` pairs keep a
per-thread call stack with inclusive/exclusive host times per routine
(reference: ``src/core/dbcsr_timings.F``), and every range is also a
``torch.profiler.record_function`` range, so it shows in profiler traces
next to the kernels it launched. Host times here are enqueue times: the
device work a range launches may finish later.

While a ``torch.profiler`` session records and CUDA is in use, a range also
records a CUDA event on the current stream at its start and at its end; the
time between the two is the range's device time (``RoutineStat.device_time``).
The pairs are resolved lazily: as they complete, while later ranges close,
and in ``timer_stats``/``timer_report``, which the caller reaches after its
own synchronise; ``reset_timers`` drops them. No range waits for the
device, and with no profiler recording no event is made.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import torch

__all__ = [
    "timeset",
    "timestop",
    "timed",
    "timer_report",
    "timer_stats",
    "timings_report_callgraph",
    "set_tracing",
    "reset_timers",
    "RoutineStat",
]


@dataclass
class RoutineStat:
    calls: int = 0
    total_time: float = 0.0  # inclusive
    self_time: float = 0.0  # exclusive
    max_total: float = 0.0
    device_time: float = 0.0  # between the range's CUDA events, under a profiler
    device_calls: int = 0  # ranges whose device time is resolved


@dataclass
class _Frame:
    name: str
    t0: float
    child_time: float = 0.0
    annotation: object = None
    start: object = None  # CUDA event at the range's start, under a profiler
    stream: object = None


class _TimerEnv(threading.local):
    def __init__(self) -> None:
        self.stack: List[_Frame] = []
        self.stats: Dict[str, RoutineStat] = {}
        self.edges: Dict[tuple, List[float]] = {}  # (caller, callee) -> [calls, time]
        self.pending: deque = deque()  # (name, start event, end event), in stop order


_env = _TimerEnv()
_tracing: bool = True  # process-wide, like the reference's toggle


def timeset(name: str) -> None:
    frame = _Frame(name, time.perf_counter())
    if _tracing:
        frame.annotation = torch.profiler.record_function(name)
        frame.annotation.__enter__()
    if torch.cuda.is_initialized() and torch.autograd._profiler_enabled():
        frame.stream = torch.cuda.current_stream()
        frame.start = torch.cuda.Event(enable_timing=True)
        frame.start.record(frame.stream)
    _env.stack.append(frame)


def timestop(name: Optional[str] = None) -> None:
    frame = _env.stack.pop()
    if name is not None and frame.name != name:
        raise RuntimeError(f"timer mismatch: stopped {name!r}, top was {frame.name!r}")
    if frame.annotation is not None:
        frame.annotation.__exit__(None, None, None)
    if frame.start is not None:
        end = torch.cuda.Event(enable_timing=True)
        end.record(frame.stream)
        _env.pending.append((frame.name, frame.start, end))
    dt = time.perf_counter() - frame.t0
    st = _env.stats.setdefault(frame.name, RoutineStat())
    st.calls += 1
    st.total_time += dt
    st.self_time += dt - frame.child_time
    st.max_total = max(st.max_total, dt)
    if _env.stack:
        _env.stack[-1].child_time += dt
        edge = _env.edges.setdefault((_env.stack[-1].name, frame.name), [0, 0.0])
        edge[0] += 1
        edge[1] += dt
    if _env.pending:
        _resolve_events(wait=False)


@contextmanager
def timed(name: str) -> Iterator[None]:
    timeset(name)
    try:
        yield
    finally:
        timestop(name)


def set_tracing(enabled: bool) -> None:
    """Toggle the profiler ranges of timed regions, process-wide."""
    global _tracing
    _tracing = bool(enabled)


def _resolve_events(wait: bool) -> None:
    """Add the device time of pending event pairs to their routines: those
    already complete (``query``), or with ``wait`` every one, waiting for
    the ones the device has not reached yet."""
    pending = _env.pending
    while pending:
        name, start, end = pending[0]
        if wait:
            end.synchronize()
        elif not end.query():
            return
        pending.popleft()
        st = _env.stats.setdefault(name, RoutineStat())
        st.device_time += start.elapsed_time(end) * 1e-3
        st.device_calls += 1


def reset_timers() -> None:
    _env.stats.clear()
    _env.stack.clear()
    _env.edges.clear()
    _env.pending.clear()


def timer_stats() -> Dict[str, RoutineStat]:
    """The routines' times; call it after synchronising the device, so that
    device times are complete without waiting."""
    _resolve_events(wait=True)
    return dict(_env.stats)


def timer_report(out=None, max_rows: int = 40) -> str:
    """Per-routine table sorted by self time, with a ``device[s]`` column
    when some routine has device time (under a profiler, on CUDA)."""
    _resolve_events(wait=True)
    rows = sorted(_env.stats.items(), key=lambda kv: -kv[1].self_time)[:max_rows]
    device = any(st.device_calls for st in _env.stats.values())
    lines = [f"{'routine':<44} {'calls':>7} {'self[s]':>10} {'total[s]':>10} {'max[s]':>10}"
             + (f" {'device[s]':>10}" if device else "")]
    for name, st in rows:
        lines.append(
            f"{name:<44} {st.calls:>7} {st.self_time:>10.4f} {st.total_time:>10.4f} {st.max_total:>10.4f}"
            + (f" {st.device_time:>10.4f}" if device else "")
        )
    text = "\n".join(lines)
    if out is not None:
        print(text, file=out)
    return text


def timings_report_callgraph(path: str) -> None:
    """Write the timer call graph in callgrind format for kcachegrind
    (``timings_report_callgraph``, reference
    ``src/core/dbcsr_timings_report.F:303``). Costs are microseconds of host
    time; edges carry call counts and inclusive times."""
    with open(path, "w") as f:
        f.write("# callgrind format — dbcsr_tpu_torch timer callgraph\n")
        f.write("events: Walltime_us\n\n")
        for name, st in sorted(_env.stats.items()):
            f.write(f"fn={name}\n")
            f.write(f"1 {max(int(st.self_time * 1e6), 0)}\n")
            for (caller, callee), (calls, t) in sorted(_env.edges.items()):
                if caller != name:
                    continue
                f.write(f"cfn={callee}\n")
                f.write(f"calls={int(calls)} 1\n")
                f.write(f"1 {max(int(t * 1e6), 0)}\n")
            f.write("\n")
