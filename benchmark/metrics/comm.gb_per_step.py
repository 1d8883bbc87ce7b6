"""Bytes this process moved between processes a step in the traced window
(GB): ``bytes_sent + bytes_received`` of the program's transfer counts
(``dist/comm.py``), process 0's, over the calls."""


def read(ctx):
    c = ctx.counters
    if not ctx.calls or "bytes_sent" not in c or "bytes_received" not in c:
        return None
    return (c["bytes_sent"] + c["bytes_received"]) / ctx.calls / 1e9
