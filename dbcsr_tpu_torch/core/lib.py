"""Library lifecycle: init / finalize / statistics.

Port of ``dbcsr_tpu/core/lib.py`` (reference ``src/core/dbcsr_lib.F``).
Init loads the config (environment overrides), resets timers and
statistics, and pins torch's float32 matmul and convolution precision to
IEEE float32: TF32 is off unless a call asks for ``matmul_precision="high"``.
There is no 64-bit switch: torch has float64 natively.
"""
from __future__ import annotations

import torch

from .config import get_config
from .stats import print_statistics, reset_stats
from .timing import reset_timers, timer_report

__all__ = ["init_lib", "finalize_lib", "print_statistics", "is_initialized"]

_initialized = False


def init_lib() -> None:
    """Initialize the library (idempotent)."""
    global _initialized
    if _initialized:
        return
    get_config()  # triggers DBCSR_* env var loading
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_stats()
    reset_timers()
    _initialized = True


def is_initialized() -> bool:
    return _initialized


def finalize_lib(print_stats: bool = False, out=None) -> None:
    """Finalize: optionally print statistics and the timer report."""
    global _initialized
    if print_stats:
        print_statistics(out=out)
        timer_report(out=out)
    _initialized = False
