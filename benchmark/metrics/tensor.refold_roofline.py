"""The refold kernel's share of its roofline (%): X's superset elements
read once and written once (``ri_work.py``) at the card's memory rate,
over the device time a step of the kernel found by name in the trace."""
import re

from benchmark.trace import device_s

KERNEL = re.compile(r"\bblock_refold_kernel\b")


def read(ctx):
    if ctx.trace is None or not ctx.calls:
        return None
    from benchmark.ri_work import ri_work
    from benchmark.workcount import peak

    s = device_s(ctx.trace, lambda n: bool(KERNEL.search(n))) / ctx.calls
    row = peak(ctx.kind)
    if not s or row is None:
        return None
    return 100.0 * ri_work(ctx.job.config).refold_bytes / row["bytes_per_s"] / s
