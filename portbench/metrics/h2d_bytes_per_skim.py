"""cascade: host-to-device bytes a skim, as the port counts them where each
copy is issued (the ``query`` span's ``h2d_bytes``; None without it)."""

from portbench import spans


def read(ctx):
    skims = spans.detailed(ctx)
    if not skims or any("h2d_bytes" not in q.attrs for _, q in skims):
        return None
    return sum(q.attrs["h2d_bytes"] for _, q in skims) / len(skims)
