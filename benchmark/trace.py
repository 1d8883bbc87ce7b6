"""Reduction of a ``torch.profiler`` trace (its Chrome-trace export) to
what the per-layer readers and the result's ``device`` and ``breakdown``
need: device activity inside the benchmark's window range, the host ranges
around it, busy time and the idle gaps. The harness's own pauses in the
window (``bench.keep``: a judged output copied to host memory) are left
out of it, with the device work inside them. Times in the trace are in µs."""
from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

WINDOW = "bench.window"
PAUSE = "bench.keep"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the port's product kernels: every ``__global__`` of ``csrc/tile_kernel.cuh``
PRODUCT_KERNEL = re.compile(r"\btile_\w*kernel\b")
NCCL = re.compile(r"nccl", re.IGNORECASE)


@dataclass
class Trace:
    window: Tuple[float, float]
    device: List[Tuple[str, float, float]] = field(default_factory=list)  # name, start, end
    host: List[Tuple[str, float, float]] = field(default_factory=list)
    paused: List[Tuple[float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        span = self.window[1] - self.window[0] - sum(b - a for a, b in self.paused)
        return span * 1e-6


def read_chrome(path: str) -> Optional[Trace]:
    """The trace at ``path``, clipped to the benchmark's window range; None
    without one."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    wins = [e for e in xs if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not wins:
        return None
    w0 = float(wins[0]["ts"])
    w1 = w0 + float(wins[0]["dur"])
    tr = Trace(window=(w0, w1))
    tr.paused = sorted((max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1))
                       for e in xs if e.get("cat") == "user_annotation"
                       and e.get("name") == PAUSE)

    def in_pause(t0: float, t1: float) -> bool:
        mid = 0.5 * (t0 + t1)
        return any(a <= mid <= b for a, b in tr.paused)

    for e in xs:
        t0 = float(e["ts"])
        t1 = t0 + float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            t0, t1 = max(t0, w0), min(t1, w1)
            if t1 > t0 and not in_pause(t0, t1):
                tr.device.append((e.get("name", "?"), t0, t1))
        elif e.get("cat") == "user_annotation" and t1 > w0 and t0 < w1:
            tr.host.append((e.get("name", "?"), t0, t1))
    tr.device.sort(key=lambda x: x[1])
    return tr


def _merged(tr: Trace, spans=()) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for t0, t1 in sorted([(t0, t1) for _, t0, t1 in tr.device] + list(spans)):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [(a, b) for a, b in out]


def busy_s(tr: Trace) -> float:
    """Seconds of the window in which some operation ran on the device."""
    return sum(b - a for a, b in _merged(tr)) * 1e-6


def device_s(tr: Trace, pick: Callable[[str], bool]) -> float:
    """Summed device seconds of the operations whose name ``pick`` takes."""
    return sum(t1 - t0 for name, t0, t1 in tr.device if pick(name)) * 1e-6


def is_product_kernel(name: str) -> bool:
    return bool(PRODUCT_KERNEL.search(name))


def is_nccl(name: str) -> bool:
    return bool(NCCL.search(name))


def top_ops(tr: Trace, n: int = 10) -> list:
    """The ``n`` device operations that took most time: [name, seconds]."""
    tot = {}
    for name, t0, t1 in tr.device:
        tot[name] = tot.get(name, 0.0) + (t1 - t0) * 1e-6
    return [[k[:200], v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(tr: Trace, n: int = 10) -> list:
    """The ``n`` longest idle gaps of the device in the window, each named by
    the innermost host range open when it began: [name, seconds]. The
    harness's pauses are no gap."""
    edges, last = [], tr.window[0]
    for a, b in _merged(tr, tr.paused):
        if a > last:
            edges.append((last, a))
        last = max(last, b)
    if tr.window[1] > last:
        edges.append((last, tr.window[1]))
    edges.sort(key=lambda g: g[0] - g[1])
    out = []
    for g0, g1 in edges[:n]:
        inner = [h for h in tr.host if h[1] <= g0 < h[2]]
        name = max(inner, key=lambda h: h[1])[0] if inner else "(no host range)"
        out.append([name[:200], (g1 - g0) * 1e-6])
    return out
