"""The product kernels' share of their roofline (%): the least time the
card could take for the work the inputs need (``workcount.py``: block
triples, stored elements) over the kernels' device time a step."""
from benchmark.trace import device_s, is_product_kernel
from benchmark.workcount import bound_s


def read(ctx):
    if ctx.trace is None or not ctx.calls:
        return None
    s = device_s(ctx.trace, is_product_kernel) / ctx.calls
    bound = bound_s(ctx.work, ctx.kind, ctx.job.config["dtype"])
    return 100.0 * bound / s if s and bound else None
