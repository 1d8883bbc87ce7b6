"""Host seconds a call in the program's ``multiply/plan`` timer (ms):
the filtered symbolic product with its host norms."""


def read(ctx):
    calls, total = ctx.timers.get("multiply/plan", (0, 0.0))
    return total / ctx.calls * 1e3 if calls and ctx.calls else None
