"""planning: milliseconds a skim in the ``plan`` span that
``SkimEngine.run(..., tracer=Tracer())`` records (query parse, planner,
zone maps, cascade plan)."""


def read(ctx):
    plans = ctx.mean(s.plan_s for s in ctx.skims)
    return None if plans is None else 1e3 * plans
