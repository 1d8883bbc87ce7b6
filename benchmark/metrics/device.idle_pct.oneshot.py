"""Share of the traced window of one-shot calls with no device operation (%)."""
from benchmark.readers import idle_pct as read  # noqa: F401
