"""Device time of the port's product kernels a step (ms), found by name
in the trace."""
from benchmark.trace import device_s, is_product_kernel


def read(ctx):
    if ctx.trace is None or not ctx.calls:
        return None
    s = device_s(ctx.trace, is_product_kernel)
    return s / ctx.calls * 1e3 if s else None
