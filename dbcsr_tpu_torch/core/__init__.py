from .config import (
    Config,
    config_override,
    get_config,
    print_config,
    reset_config,
    set_config,
)
from .errors import DbcsrError, dbcsr_abort, dbcsr_assert, dbcsr_warn
from .lib import finalize_lib, init_lib, is_initialized
from .stats import get_stats, print_statistics, reset_stats
from .timing import reset_timers, set_tracing, timed, timer_report, timeset, timestop

__all__ = [
    "Config", "config_override", "get_config", "print_config", "reset_config", "set_config",
    "DbcsrError", "dbcsr_abort", "dbcsr_assert", "dbcsr_warn",
    "finalize_lib", "init_lib", "is_initialized",
    "get_stats", "print_statistics", "reset_stats",
    "timed", "timer_report", "timeset", "timestop", "reset_timers", "set_tracing",
]
