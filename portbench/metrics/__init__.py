"""Per-layer metrics, one reader a metric, found by the metric's name.

``read(ctx: portbench.context.Context) -> float | None``; a reader that
finds nothing to read returns None and the metric is left out of the line.
"""
