"""CUDA kernels: milliseconds of device time a skim, summed over every
kernel of the profiler's device trace (copies and sets left out)."""


def read(ctx):
    if ctx.trace is None or not ctx.skims:
        return None
    return 1e3 * ctx.trace.kernel_s() / len(ctx.skims)
