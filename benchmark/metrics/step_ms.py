"""The whole window over the plan-once steps completed in it (ms)."""
from benchmark.readers import window_ms as read  # noqa: F401
