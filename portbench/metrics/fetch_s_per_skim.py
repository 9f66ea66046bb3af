"""decode tier: seconds a skim in the port's ``fetch`` spans, the store's
blob reads and digests (host-detail spans; None without them)."""

from portbench import spans


def read(ctx):
    return spans.kind_s_per_skim(ctx, "fetch")
