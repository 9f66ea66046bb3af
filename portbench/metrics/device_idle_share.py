"""device: the share of the window in which no kernel, copy or set ran on
the card (1 - the union of the profiler's device intervals over the
window)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 1.0 - ctx.trace.busy_s / ctx.trace.window_s
