"""Device time a step of every operation that is neither a port product
kernel nor NCCL (ms): norms, the keep mask, alignment, gathers, copies."""
from benchmark.trace import device_s, is_nccl, is_product_kernel


def read(ctx):
    if ctx.trace is None or not ctx.calls or not ctx.trace.device:
        return None
    s = device_s(ctx.trace, lambda n: not is_product_kernel(n) and not is_nccl(n))
    return s / ctx.calls * 1e3
