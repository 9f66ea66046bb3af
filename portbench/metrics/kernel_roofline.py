"""CUDA kernels: the least time the skims of the window need, over the
kernels' device time, in percent.  The least time is the bytes
``portbench.roofline.least_bytes`` counts for each skim's file from the
data and the reference's survivors, at the H100's 3.35 TB/s; it is the
least work only where every window scans and every stage runs."""

from portbench import peaks


def read(ctx):
    if ctx.trace is None or not ctx.skims:
        return None
    kernel_s = ctx.trace.kernel_s()
    if kernel_s <= 0:
        return None
    least_s = sum(ctx.least_bytes(s.file) for s in ctx.skims) / peaks.HBM_BYTES_PER_S
    return 100.0 * least_s / kernel_s
