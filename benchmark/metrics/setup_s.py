"""From the start of the process to the first timed call (s): imports,
build (first run only), operands, the cell's executor and its first call."""


def read(ctx):
    return ctx.setup_s
