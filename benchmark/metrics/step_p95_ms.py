"""The 95th percentile of every step's time in the window (ms)."""
import numpy as np


def read(ctx):
    return float(np.percentile(ctx.call_s, 95)) * 1e3 if ctx.calls else None
