"""Multiplication statistics counters.

Port of ``dbcsr_tpu/core/stats.py`` for the local multiply: effective flops
are counted at user-block granularity (2·m·n·k per contributing block
triple), hardware flops at tile granularity (2·T³ per stack entry, or the
full dense grid); their ratio is the tile packing efficiency. Reference:
``src/mm/dbcsr_mm_sched.F:392-663``, printed like
``dbcsr_print_statistics`` (``src/core/dbcsr_lib.F:348``).
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["MMStats", "get_stats", "reset_stats", "print_statistics"]


@dataclass
class MMStats:
    num_multiplications: int = 0
    total_flops: float = 0.0  # effective, 2*m*n*k per contributing triple
    hardware_flops: float = 0.0  # tile-granular flops actually issued
    max_memory_bytes: int = 0  # peak device memory seen after a multiply


_stats = MMStats()


def get_stats() -> MMStats:
    return _stats


def reset_stats() -> None:
    global _stats
    _stats = MMStats()


def print_statistics(out=None) -> str:
    s = _stats
    lines = ["-" * 72, " DBCSR-TORCH STATISTICS", "-" * 72]
    lines.append(f" multiplications          {s.num_multiplications}")
    lines.append(f" effective flops          {s.total_flops:.6E}")
    lines.append(f" hardware (tile) flops    {s.hardware_flops:.6E}")
    if s.hardware_flops > 0:
        lines.append(
            f" tile packing efficiency  {s.total_flops / s.hardware_flops:.3f}"
        )
    if s.max_memory_bytes:
        lines.append(
            f" max device memory        {s.max_memory_bytes / 1e9:.3f} GB"
        )
    text = "\n".join(lines)
    if out is not None:
        print(text, file=out)
    return text
