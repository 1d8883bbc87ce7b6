"""Reading the program's own spans and counters after a traced window:
``dbcsr_tpu_torch.core.timing`` timers (reset just before the window, so
they hold the window alone) and ``core.stats`` counters. A program without
the span or counter gives None."""


def device_ms(ctx, name: str):
    """Device time a step of the program's span ``name`` (ms): its CUDA
    events under the window's profiler."""
    from dbcsr_tpu_torch.core.timing import timer_stats

    st = timer_stats().get(name)
    if st is None or not getattr(st, "device_calls", 0) or not ctx.calls:
        return None
    return st.device_time / ctx.calls * 1e3
