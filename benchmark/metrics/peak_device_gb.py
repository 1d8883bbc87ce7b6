"""The program's device peak (GB): ``torch.cuda.max_memory_allocated`` over
set-up, and over each call of the window less the outputs that the judge
keeps for after it (a caller holds one C at a time)."""


def read(ctx):
    return ctx.peak_bytes / 1e9 if ctx.peak_bytes else None
