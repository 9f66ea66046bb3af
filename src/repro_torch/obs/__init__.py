"""Observability: span tracing and the versioned result report schema
(DESIGN.md §13).  Everything is off (no-op tracer) unless a caller opts
in."""

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
    "NULL_TRACER",
    "NullTracer",
    "SCHEMA_VERSION",
    "SkimReport",
    "Span",
    "Tracer",
    "chrome_trace",
    "dump_chrome_trace",
    "make_extras",
    "trace_json",
]
