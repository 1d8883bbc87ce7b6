"""Share of the traced window of plan-once steps with no device operation (%)."""
from benchmark.readers import idle_pct as read  # noqa: F401
