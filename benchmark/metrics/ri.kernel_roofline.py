"""The product kernels' share of the RI-HFX step's roofline (%): the least
time the card could take for the work both contractions need
(``ri_work.py``: block triples, B's, D's and X's superset elements) over
the product kernels' device time a step."""
from benchmark.trace import device_s, is_product_kernel


def read(ctx):
    if ctx.trace is None or not ctx.calls:
        return None
    from benchmark.ri_work import ri_work
    from benchmark.workcount import bound_s

    s = device_s(ctx.trace, is_product_kernel) / ctx.calls
    bound = bound_s(ri_work(ctx.job.config).step, ctx.kind, ctx.job.config["dtype"])
    return 100.0 * bound / s if s and bound else None
