"""Device time a step of the program's ``cannon/shift`` span (ms): the
Cannon ring shifts between ticks, each to its completion on the device."""
from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "cannon/shift")
