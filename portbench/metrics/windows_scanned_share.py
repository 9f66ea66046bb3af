"""planning: windows the zone maps left to scan over all windows
(``SkimResult.plan.window_decisions``; none decided means all scan)."""


def read(ctx):
    total = sum(s.windows for s in ctx.skims)
    return sum(s.windows_scanned for s in ctx.skims) / total if total else None
