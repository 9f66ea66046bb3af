"""Observability: span tracing, metrics, and the versioned result
report schema (DESIGN.md §13).  Everything is off (no-op tracer) unless
a caller opts in."""

from repro_torch.obs.metrics import (
    MetricsRegistry,
    collect_cache_metrics,
    observed_phase2_bytes,
    observed_stage_bytes,
    priced_stage_bytes,
    unified_cache_report,
)
from repro_torch.obs.schema import KNOWN_EXTRAS, SCHEMA_VERSION, SkimReport, make_extras
from repro_torch.obs.trace import (
    NULL_TRACER,
    NullTracer,
    Span,
    Tracer,
    chrome_trace,
    dump_chrome_trace,
    trace_json,
)

__all__ = [
    "KNOWN_EXTRAS",
    "MetricsRegistry",
    "NULL_TRACER",
    "NullTracer",
    "SCHEMA_VERSION",
    "SkimReport",
    "Span",
    "Tracer",
    "chrome_trace",
    "collect_cache_metrics",
    "dump_chrome_trace",
    "make_extras",
    "observed_phase2_bytes",
    "observed_stage_bytes",
    "priced_stage_bytes",
    "trace_json",
    "unified_cache_report",
]
