"""device: seconds a skim the host spends blocked on the card, in the
port's ``device_wait`` spans (host-detail spans; None without them)."""

from portbench import spans


def read(ctx):
    return spans.kind_s_per_skim(ctx, "device_wait")
