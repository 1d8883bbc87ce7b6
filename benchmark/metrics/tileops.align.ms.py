"""Device time a step of the program's ``executor/align`` span (ms): the
gather of the product tiles into C's store layout."""
from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "executor/align")
