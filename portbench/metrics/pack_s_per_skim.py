"""CUDA kernels: seconds a skim in the port's ``pack`` spans, the host work
that lays out the kernels' inputs (decode rounds, padded planes, staged
buffers; host-detail spans, None without them)."""

from portbench import spans


def read(ctx):
    return spans.kind_s_per_skim(ctx, "pack")
