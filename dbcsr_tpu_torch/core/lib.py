"""Library lifecycle: init / finalize / statistics.

Port of ``dbcsr_tpu/core/lib.py`` (reference ``src/core/dbcsr_lib.F``).
Init loads the config (environment overrides), resets timers and
statistics, and pins torch's float32 matmul and convolution precision to
IEEE float32: TF32 is off unless a call asks for ``matmul_precision="high"``.
There is no 64-bit switch: torch has float64 natively. ``distributed=True``
brings up ``torch.distributed`` (the JAX package's ``jax.distributed``;
``dist/comm.py``), and ``finalize_lib`` tears down what init brought up.
"""
from __future__ import annotations

from typing import Optional

import torch

from .config import get_config
from .stats import print_statistics, reset_stats
from .timing import reset_timers, timer_report

__all__ = ["init_lib", "finalize_lib", "print_statistics", "is_initialized"]

_initialized = False


def init_lib(
    *,
    distributed: bool = False,
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> None:
    """Initialize the library (idempotent).

    ``distributed=True`` brings up the world of a multi-process run (once):
    ``coordinator_address`` is ``"host:port"``, a ``tcp://`` or ``file://``
    URL, or None for torchrun's ``env://`` variables; ``num_processes`` and
    ``process_id`` the world's size and this process's rank; ``device`` this
    process's device (default ``cuda:{LOCAL_RANK or process_id} %
    device_count``; without CUDA pass ``"cpu"``); ``backend`` ``"nccl"`` (the
    default on a card, one process a card) or ``"gloo"`` (the CPU's, and
    several processes on one card). Every grid made afterwards deals its
    ranks over the processes (``dist/grid.py``)."""
    global _initialized
    if distributed:
        from ..dist import comm

        if not comm.is_up():
            comm.start(coordinator_address=coordinator_address,
                       num_processes=num_processes, process_id=process_id,
                       backend=backend, device=device)
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
    """Finalize: optionally print statistics and the timer report, then
    destroy the process group that ``init_lib(distributed=True)`` created."""
    global _initialized
    from ..dist import comm

    if print_stats:
        print_statistics(out=out)
        timer_report(out=out)
    comm.stop()
    _initialized = False
