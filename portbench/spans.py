"""What the per-layer readers take from the port's host-detail spans.

A skim traced with host detail (``Tracer()``'s default) has a ``query``
span carrying ``clock_ns``; its leaves name the host work of the skim,
one kind per kind of work.  A skim without them (a program that records
no host detail) gives the readers nothing, and they return None.
"""

from __future__ import annotations

# the kinds of host work a detailed skim records; ``decompress`` and
# ``deserialize`` may hold a decode round's pack .. unpack leaves
LEAF_KINDS = frozenset({"fetch", "ledger", "pack", "launch", "device_wait", "unpack",
                        "evaluate", "decompress", "deserialize"})


def query_span(spans):
    """The skim's detailed ``query`` span, or None."""
    for sp in spans:
        if sp.kind == "query" and "clock_ns" in sp.attrs and sp.t1 is not None:
            return sp
    return None


def detailed(ctx) -> list:
    """The window's skims with their query spans, or [] when any skim has
    no detailed query span."""
    out = []
    for skim in ctx.skims:
        q = query_span(skim.spans)
        if q is None:
            return []
        out.append((skim, q))
    return out


def kind_s_per_skim(ctx, kind: str) -> float | None:
    """Seconds a skim in spans of ``kind``, over the window's skims."""
    skims = detailed(ctx)
    if not skims:
        return None
    return sum(sum(sp.t1 - sp.t0 for sp in s.spans if sp.kind == kind and sp.t1 is not None)
               for s, _ in skims) / len(skims)


def leaves(spans) -> list:
    """Spans of the leaf kinds, and spans no span names as its parent
    (the output's ``write``, a skipped window), the query left out."""
    parents = {sp.parent for sp in spans}
    return [sp for sp in spans if sp.t1 is not None and sp.kind != "query"
            and (sp.kind in LEAF_KINDS or sp.sid not in parents)]


def covered_s(intervals, t0: float, t1: float) -> float:
    """Seconds of ``[t0, t1]`` inside the union of ``intervals``."""
    total, end = 0.0, t0
    clipped = ((max(a, t0), min(b, t1)) for a, b in intervals)
    for a, b in sorted((a, b) for a, b in clipped if b > a):
        if b > end:
            total += b - max(a, end)
            end = b
    return total
