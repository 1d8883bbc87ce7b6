"""Call-stack timers with profiler ranges.

Port of ``dbcsr_tpu/core/timing.py``: ``timeset``/``timestop`` pairs keep a
per-thread call stack with inclusive/exclusive host times per routine
(reference: ``src/core/dbcsr_timings.F``), and every range is also a
``torch.profiler.record_function`` range, so it shows in profiler traces
next to the kernels it launched. Host times here are enqueue times: the
device work a range launches may finish later.
"""
from __future__ import annotations

import threading
import time
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


@dataclass
class _Frame:
    name: str
    t0: float
    child_time: float = 0.0
    annotation: object = None


class _TimerEnv(threading.local):
    def __init__(self) -> None:
        self.stack: List[_Frame] = []
        self.stats: Dict[str, RoutineStat] = {}
        self.edges: Dict[tuple, List[float]] = {}  # (caller, callee) -> [calls, time]


_env = _TimerEnv()
_tracing: bool = True  # process-wide, like the reference's toggle


def timeset(name: str) -> None:
    frame = _Frame(name, time.perf_counter())
    if _tracing:
        frame.annotation = torch.profiler.record_function(name)
        frame.annotation.__enter__()
    _env.stack.append(frame)


def timestop(name: Optional[str] = None) -> None:
    frame = _env.stack.pop()
    if name is not None and frame.name != name:
        raise RuntimeError(f"timer mismatch: stopped {name!r}, top was {frame.name!r}")
    if frame.annotation is not None:
        frame.annotation.__exit__(None, None, None)
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


def reset_timers() -> None:
    _env.stats.clear()
    _env.stack.clear()
    _env.edges.clear()


def timer_stats() -> Dict[str, RoutineStat]:
    return dict(_env.stats)


def timer_report(out=None, max_rows: int = 40) -> str:
    """Per-routine table sorted by self time."""
    rows = sorted(_env.stats.items(), key=lambda kv: -kv[1].self_time)[:max_rows]
    lines = [f"{'routine':<44} {'calls':>7} {'self[s]':>10} {'total[s]':>10} {'max[s]':>10}"]
    for name, st in rows:
        lines.append(
            f"{name:<44} {st.calls:>7} {st.self_time:>10.4f} {st.total_time:>10.4f} {st.max_total:>10.4f}"
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
