"""cascade: seconds a skim in the ``cascade_stage`` spans of HT nodes
(``node == "ht"``: the stage's alive-span fetch and decode, the staging of
its padded planes and the stage step), over the window's skims; None where
no skim recorded one."""


def read(ctx):
    per_skim, seen = [], False
    for skim in ctx.skims:
        stages = [sp for sp in skim.spans if sp.kind == "cascade_stage"
                  and sp.attrs.get("node") == "ht" and sp.t1 is not None]
        seen = seen or bool(stages)
        per_skim.append(sum(sp.t1 - sp.t0 for sp in stages))
    return ctx.mean(per_skim) if seen else None
