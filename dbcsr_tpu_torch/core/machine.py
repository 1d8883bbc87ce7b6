"""Machine abstraction: walltime, host/device memory, flush, energy.

Port of ``dbcsr_tpu/core/machine.py`` (reference ``dbcsr_machine``,
``src/base/dbcsr_machine.F:45-180``): ``m_walltime``, ``m_memory``
(statm-based) and friends are copies; ``m_peak_memory`` falls back to
``getrusage`` where ``/proc`` has no VmHWM. Device memory comes from torch's
CUDA caching allocator (``torch.cuda.memory_stats``), mapped onto the keys
the JAX package reads from its backend. Complex arithmetic needs no probe:
torch has it on the CPU and on CUDA.
"""
from __future__ import annotations

import os
import resource
import sys
import time
from typing import Dict, Optional

import torch

__all__ = [
    "m_walltime",
    "m_memory",
    "m_peak_memory",
    "m_flush",
    "m_energy",
    "backend_supports_complex",
    "device_memory_stats",
]

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def m_walltime() -> float:
    """Monotonic wall clock in seconds (``m_walltime``)."""
    return time.monotonic()


def m_memory() -> int:
    """Current resident host memory in bytes (``m_memory``; /proc/statm
    like the reference's posix implementation)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE
    except (OSError, IndexError, ValueError):
        return 0


def m_peak_memory() -> int:
    """Peak resident host memory in bytes (VmHWM; where ``/proc`` has no
    VmHWM line, as in some containers, ``getrusage``'s maxrss)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
    except (OSError, IndexError, ValueError):
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def m_flush(stream=None) -> None:
    """Flush an output stream (``m_flush``)."""
    (stream or sys.stdout).flush()


def backend_supports_complex() -> bool:
    """Whether the backend can do complex arithmetic: always, in torch."""
    return True


def m_energy() -> float:
    """Cumulative energy counter in joules (``m_energy``,
    ``src/base/dbcsr_machine.F:54-180``: Cray PM counters there, 0.0
    elsewhere). Reads the host RAPL counter when the kernel exposes it;
    returns 0.0 otherwise, exactly like the reference off-Cray."""
    try:
        with open("/sys/class/powercap/intel-rapl:0/energy_uj") as f:
            return int(f.read()) / 1e6
    except (OSError, ValueError):
        return 0.0


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """Device allocator statistics of a CUDA device: ``bytes_in_use``,
    ``peak_bytes_in_use`` (torch's allocated bytes, current and peak) and
    ``bytes_limit`` (the card's memory), the keys the JAX package reads
    from its backend (the reference's per-multiply peak-memory tracking,
    ``dbcsr_mm_cannon.F:1723``). None for a CPU device, as the JAX CPU
    device gives; ``device=None`` is the current CUDA device, if any."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(device).total_memory),
    }
