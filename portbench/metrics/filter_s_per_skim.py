"""Seconds a skim in the ``filter`` stage of ``SkimResult.breakdown`` (the
engine's own timer around that stage)."""


def read(ctx):
    return ctx.mean(s.breakdown["filter"] for s in ctx.skims)
