"""engine: the share of the skims' ``query`` spans under no leaf span of
the port's host detail (1 - the union of each skim's leaves within its
query span, over the query spans' time; None without them)."""

from portbench import spans


def read(ctx):
    skims = spans.detailed(ctx)
    total = sum(q.t1 - q.t0 for _, q in skims)
    if total <= 0:
        return None
    covered = sum(spans.covered_s([(sp.t0, sp.t1) for sp in spans.leaves(s.spans)],
                                  q.t0, q.t1) for s, q in skims)
    return 1.0 - covered / total
