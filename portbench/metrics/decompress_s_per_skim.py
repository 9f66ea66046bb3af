"""Seconds a skim in the ``decompress`` stage of ``SkimResult.breakdown`` (the
engine's own timer around that stage)."""


def read(ctx):
    return ctx.mean(s.breakdown["decompress"] for s in ctx.skims)
