"""Counters/gauges/histograms + priced-vs-observed calibration store.

:class:`MetricsRegistry` is the single sink for operational numbers that
used to live in scattered per-component counters: bytes fetched/skipped,
cache hit rates (decode cache and cluster result cache, unified behind
one gauge family), stage pass rates, queue waits, time-to-first-partial,
per-tenant quota spend.  Zero dependencies, deterministic snapshots
(keys are sorted), safe under the cluster's thread-pool gather.

The **calibration store** closes ROADMAP item 1's feedback loop: the
service records ``observed_bytes / priced_bytes`` per cascade-stage kind
at settle time (:meth:`MetricsRegistry.record_price_ratio`), and
:meth:`MetricsRegistry.calibration_priors` turns the accumulated ratios
into the ``calibration`` mapping that
:func:`repro_torch.core.plan.estimate_plan_bytes` consumes as a prior.
"""

from __future__ import annotations

import threading


def _label_key(name: str, labels: dict) -> tuple:
    return (name, tuple(sorted(labels.items())))


def _render_key(key: tuple) -> str:
    name, labels = key
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class _Hist:
    """Count/sum/min/max plus deterministic power-of-4 buckets (upper
    bounds 4**k); enough for queue-wait / first-partial distributions
    without pulling in a real histogram library."""

    __slots__ = ("count", "sum", "min", "max", "buckets")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self.buckets: dict[float, int] = {}

    def observe(self, value: float) -> None:
        self.count += 1
        self.sum += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)
        le = 0.0
        if value > 0:
            le = 1.0
            while value > le:
                le *= 4.0
        self.buckets[le] = self.buckets.get(le, 0) + 1

    def as_dict(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "mean": (self.sum / self.count) if self.count else None,
            "buckets": {str(k): self.buckets[k] for k in sorted(self.buckets)},
        }


class MetricsRegistry:
    """Label-aware counters, gauges and histograms.

    Metric identity is ``(name, sorted(labels))`` so
    ``inc("cache_hits", cache="decode")`` and ``cache="result"`` stay
    distinct series under one name.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[tuple, float] = {}
        self._gauges: dict[tuple, float] = {}
        self._hists: dict[tuple, _Hist] = {}
        self._calib: dict[str, dict] = {}

    # -- counters ------------------------------------------------------------

    def inc(self, name: str, value: float = 1, **labels) -> None:
        key = _label_key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + value

    def counter(self, name: str, **labels) -> float:
        return self._counters.get(_label_key(name, labels), 0)

    # -- gauges --------------------------------------------------------------

    def set_gauge(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._gauges[_label_key(name, labels)] = value

    def gauge(self, name: str, **labels):
        return self._gauges.get(_label_key(name, labels))

    # -- histograms ----------------------------------------------------------

    def observe(self, name: str, value: float, **labels) -> None:
        key = _label_key(name, labels)
        with self._lock:
            hist = self._hists.get(key)
            if hist is None:
                hist = self._hists[key] = _Hist()
            hist.observe(float(value))

    def histogram(self, name: str, **labels) -> dict | None:
        hist = self._hists.get(_label_key(name, labels))
        return hist.as_dict() if hist is not None else None

    # -- calibration (priced vs observed bytes per stage kind) ---------------

    def record_price_ratio(self, kind: str, priced_bytes, observed_bytes) -> None:
        """Accumulate one settled job's priced/observed byte pair for a
        cascade-stage kind (``"cut"``, ``"trigger"``, ``"phase2"``,
        ``"total"``, ...)."""
        with self._lock:
            cell = self._calib.get(kind)
            if cell is None:
                cell = self._calib[kind] = {"n": 0, "priced": 0, "observed": 0}
            cell["n"] += 1
            cell["priced"] += int(priced_bytes)
            cell["observed"] += int(observed_bytes)

    def calibration_summary(self) -> dict:
        """Per-kind totals and the observed/priced ratio (None until a
        kind has priced bytes to divide by)."""
        out = {}
        with self._lock:
            for kind in sorted(self._calib):
                cell = self._calib[kind]
                ratio = (cell["observed"] / cell["priced"]) if cell["priced"] > 0 else None
                out[kind] = {
                    "n": cell["n"],
                    "priced_bytes": cell["priced"],
                    "observed_bytes": cell["observed"],
                    "ratio": ratio,
                }
        return out

    def calibration_priors(self, min_samples: int = 1) -> dict:
        """The ``{stage_kind: ratio}`` mapping `estimate_plan_bytes`
        accepts as its ``calibration`` argument.  Kinds with fewer than
        ``min_samples`` settled jobs (or zero priced bytes) are omitted
        — the estimator falls back to its uncalibrated prior for them."""
        return {
            kind: cell["ratio"]
            for kind, cell in self.calibration_summary().items()
            if cell["ratio"] is not None and cell["n"] >= min_samples
        }

    # -- export --------------------------------------------------------------

    def snapshot(self) -> dict:
        """Deterministic flat view: ``{"counters": {...}, "gauges":
        {...}, "histograms": {...}, "calibration": {...}}`` with
        ``name{label=value}`` keys, sorted."""
        with self._lock:
            counters = {_render_key(k): v for k, v in self._counters.items()}
            gauges = {_render_key(k): v for k, v in self._gauges.items()}
            hists = {_render_key(k): h.as_dict() for k, h in self._hists.items()}
        return {
            "counters": dict(sorted(counters.items())),
            "gauges": dict(sorted(gauges.items())),
            "histograms": dict(sorted(hists.items())),
            "calibration": self.calibration_summary(),
        }


# ---------------------------------------------------------------------------
# Unified cache accounting (decode cache + cluster result cache)
# ---------------------------------------------------------------------------


def unified_cache_report(store=None, result_cache=None) -> dict:
    """One shape for both caches: ``hits``/``misses``/``hit_rate``/
    ``saved_bytes``/``resident``.  ``saved_bytes`` is the byte-weighted
    savings — decoded bytes not re-decoded for the decode cache, fetch
    bytes not re-fetched for the cluster result cache."""
    report = {}
    if store is not None:
        st = store.decode_cache_stats()
        report["decode"] = {
            "hits": st["hits"],
            "misses": st["misses"],
            "hit_rate": st["hit_rate"],
            "saved_bytes": st["saved_decode_bytes"],
            "resident": st["resident"],
        }
    if result_cache is not None:
        cs = result_cache.stats
        report["result"] = {
            "hits": cs.hits,
            "misses": cs.misses,
            "hit_rate": cs.hit_rate,
            "saved_bytes": cs.saved_fetch_bytes,
            "resident": len(result_cache),
        }
    return report


def collect_cache_metrics(registry: MetricsRegistry, store=None, result_cache=None) -> dict:
    """Publish both caches into the registry as one gauge family
    (``cache_hits{cache=decode}``, ``cache_saved_bytes{cache=result}``,
    ...) and return the unified report."""
    report = unified_cache_report(store=store, result_cache=result_cache)
    for cache_name, row in report.items():
        for field, value in row.items():
            registry.set_gauge(f"cache_{field}", value, cache=cache_name)
    return report


# ---------------------------------------------------------------------------
# Priced-vs-observed helpers (consumed by SkimService._settle)
# ---------------------------------------------------------------------------


def priced_stage_bytes(estimate) -> dict:
    """Fold a CostEstimate's per-stage priced bytes by stage kind."""
    kinds = getattr(estimate, "per_stage_kinds", None) or {}
    out: dict[str, int] = {}
    for si, priced in (getattr(estimate, "per_stage", None) or {}).items():
        kind = kinds.get(si, "other")
        out[kind] = out.get(kind, 0) + int(priced)
    return out


def observed_stage_bytes(result) -> dict:
    """Fold a result's observed per-stage bytes by stage kind.  Works on
    a single-engine SkimResult (reads the ``cascade_stages`` report
    rows) and on a ClusterSkimResult (sums over shard responses)."""
    responses = getattr(result, "responses", None)
    if responses is not None:
        out: dict[str, int] = {}
        for resp in responses:
            for kind, nbytes in observed_stage_bytes(resp.result).items():
                out[kind] = out.get(kind, 0) + nbytes
        return out
    out = {}
    for row in (getattr(result, "extras", None) or {}).get("cascade_stages") or ():
        kind = row.get("kind", "other")
        out[kind] = out.get(kind, 0) + int(row.get("bytes_fetched", 0))
    return out


def observed_phase2_bytes(result):
    """Observed phase-2 bytes, or None when the result doesn't report a
    phase split (shared-scan tenants, pruned shards)."""
    responses = getattr(result, "responses", None)
    if responses is not None:
        vals = [observed_phase2_bytes(r.result) for r in responses]
        vals = [v for v in vals if v is not None]
        return sum(vals) if vals else None
    value = (getattr(result, "extras", None) or {}).get("phase2_bytes")
    return int(value) if value is not None else None


__all__ = [
    "MetricsRegistry",
    "collect_cache_metrics",
    "observed_phase2_bytes",
    "observed_stage_bytes",
    "priced_stage_bytes",
    "unified_cache_report",
]
