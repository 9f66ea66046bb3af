"""cascade: the share of the padded planes' slots that hold no object,
1 - sum(``object_slots``) / sum(``plane_slots``) over a skim's
``cascade_stage`` spans (each stage's events times its object capacity K,
as laid out for the card, and the real objects among them), averaged over
the window's skims; None where no stage span carries the counters."""


def read(ctx):
    shares = []
    for skim in ctx.skims:
        stages = [sp.attrs for sp in skim.spans
                  if sp.kind == "cascade_stage" and "plane_slots" in sp.attrs]
        planes = sum(a["plane_slots"] for a in stages)
        if planes:
            shares.append(1.0 - sum(a["object_slots"] for a in stages) / planes)
    return ctx.mean(shares)
