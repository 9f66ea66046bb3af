"""Seconds a skim in the ``deserialize`` stage of ``SkimResult.breakdown`` (the
engine's own timer around that stage)."""


def read(ctx):
    return ctx.mean(s.breakdown["deserialize"] for s in ctx.skims)
