"""The whole window over the one-shot ``multiply`` calls completed in it
(ms), apart from ``step_ms``: a host-bound call of seconds spreads unlike
a device-bound step."""
from benchmark.readers import window_ms as read  # noqa: F401
