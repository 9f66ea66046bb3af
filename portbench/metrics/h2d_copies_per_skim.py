"""cascade: host-to-device copies a skim, counted from the profiler's
device trace (``Memcpy HtoD`` events of every kind)."""


def read(ctx):
    if ctx.trace is None or not ctx.skims:
        return None
    return ctx.trace.count("Memcpy HtoD") / len(ctx.skims)
