"""Device time a step of the program's ``tensor/refold`` span (ms): every
refold of a tensor's store from one fold to another."""
from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "tensor/refold")
