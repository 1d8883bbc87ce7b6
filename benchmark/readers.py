"""Readers that several metrics share (``metrics/<name>.py`` imports the
one it is): a metric split by the end-to-end metric it moves keeps one
body."""
from benchmark.trace import busy_s


def window_ms(ctx):
    """The whole window over the calls completed in it (ms)."""
    return ctx.elapsed_s / ctx.calls * 1e3 if ctx.calls else None


def idle_pct(ctx):
    """Share of the traced window with no device operation (%)."""
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - busy_s(ctx.trace) / ctx.trace.window_s)
