"""Error handling with hookable handlers.

Copy of ``dbcsr_tpu/core/errors.py``: aborts raise ``DbcsrError``, and the
hooks are function pointers that embedding applications may replace
(reference: ``src/core/dbcsr_error_handling.F:40-107``).
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional

__all__ = ["DbcsrError", "dbcsr_abort", "dbcsr_warn", "dbcsr_assert", "set_abort_hook", "set_warn_hook"]


class DbcsrError(RuntimeError):
    """Fatal library error (reference: DBCSR_ABORT)."""


_abort_hook: Optional[Callable[[str], None]] = None
_warn_hook: Optional[Callable[[str], None]] = None


def set_abort_hook(fn: Optional[Callable[[str], None]]) -> None:
    global _abort_hook
    _abort_hook = fn


def set_warn_hook(fn: Optional[Callable[[str], None]]) -> None:
    global _warn_hook
    _warn_hook = fn


def dbcsr_abort(message: str) -> None:
    if _abort_hook is not None:
        _abort_hook(message)
    raise DbcsrError(message)


def dbcsr_warn(message: str) -> None:
    if _warn_hook is not None:
        _warn_hook(message)
        return
    warnings.warn(message, stacklevel=2)


def dbcsr_assert(cond: bool, message: str = "assertion failed") -> None:
    if not cond:
        dbcsr_abort(message)
