"""Device time a step of the program's ``filtered/mask`` span (ms): the
filtered step's keep decision, the keep mask over C's store, its cast to
C's type and the multiply that zeroes the dropped blocks."""
from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "filtered/mask")
