"""Device time a step of the program's ``filtered/norms`` span (ms): the
block norms² of the filtered step (per-tile indicator matmuls of the
squares, then the ordered segment sum over C's superset blocks)."""
from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "filtered/norms")
