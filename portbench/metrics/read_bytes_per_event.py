"""decode tier: compressed bytes fetched (phase 1 and phase 2,
``SkimResult.stats.bytes_fetched``) over the skim's input events."""


def read(ctx):
    events = sum(s.n_input for s in ctx.skims)
    return sum(s.bytes_fetched for s in ctx.skims) / events if events else None
