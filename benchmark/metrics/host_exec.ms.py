"""Host seconds a call in the program's ``multiply/exec`` timer (ms): the
local product's planning and launches (enqueue time, not device time)."""


def read(ctx):
    calls, total = ctx.timers.get("multiply/exec", (0, 0.0))
    return total / ctx.calls * 1e3 if calls and ctx.calls else None
