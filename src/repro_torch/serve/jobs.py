"""Job model for the async skim service (DESIGN.md §12).

A :class:`SkimJob` is one submitted query moving through the lifecycle

    submit -> PENDING -> RUNNING -> DONE | FAILED | CANCELLED
                   \\-> REJECTED            (admission control)

Everything here is deliberately inert data + pure pricing:

  * :func:`price_query` prices a query with the cascade cost model
    (:func:`repro_torch.core.plan.estimate_plan_bytes`) **before** it runs —
    basket metadata only, zero bytes fetched — and wraps the numbers in
    a :class:`CostEstimate`, the admission-control currency;
  * :class:`TenantQuota` is a tenant's byte/wall budget and fair-share
    weight; the service enforces it against priced estimates;
  * :class:`PartialResult` is one streamed window-granular ledger entry
    (survivor columns included), appended to ``job.partials`` as the
    executor completes each window;
  * :class:`ManualClock` is the injectable deterministic clock — tests
    advance it explicitly, so every timestamp is replayable.

Scheduling itself lives in :mod:`repro_torch.serve.service`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.data.store import FetchStats

# -- job lifecycle states ---------------------------------------------------

PENDING = "PENDING"
RUNNING = "RUNNING"
DONE = "DONE"
FAILED = "FAILED"
CANCELLED = "CANCELLED"
REJECTED = "REJECTED"
#: states a job can never leave
TERMINAL = frozenset({DONE, FAILED, CANCELLED, REJECTED})


class ManualClock:
    """Injectable deterministic clock: ``now()`` only moves when the
    owner calls :meth:`advance`.  The service stamps every lifecycle
    transition with it, so a test controls — and can assert — all
    timestamps without wall-clock sleeps."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError("clocks only move forward")
        self._now += float(dt)
        return self._now


@dataclass(frozen=True)
class CostEstimate:
    """A query's plan-priced cost, computed before any basket moves.

    ``est_bytes`` is the admission currency (phase 1 + phase 2);
    ``est_wall_s`` the modeled link time of moving them.  ``per_stage``
    keeps the per-cascade-stage byte split for explainable rejections.
    """

    est_bytes: int
    est_phase1_bytes: int
    est_phase2_bytes: int
    est_requests: int
    est_wall_s: float
    est_selectivity: float
    n_windows: int
    n_windows_pruned: int
    per_stage: dict = field(default_factory=dict)
    # stage index -> stage kind ("cut"/"trigger"/"mass"/...), the join
    # key for priced-vs-observed calibration (repro_torch.obs.metrics)
    per_stage_kinds: dict = field(default_factory=dict)

    def describe(self) -> str:
        return (
            f"~{self.est_bytes / 1e6:.2f} MB "
            f"(p1 {self.est_phase1_bytes / 1e6:.2f} + "
            f"p2 {self.est_phase2_bytes / 1e6:.2f}), "
            f"~{self.est_wall_s * 1e3:.1f} ms modeled, "
            f"sel~{self.est_selectivity:.3f}, "
            f"{self.n_windows_pruned}/{self.n_windows} windows pruned"
        )


def price_query(
    query,
    store,
    window_events: int | None = None,
    link=None,
    calibration: dict | None = None,
) -> CostEstimate:
    """Price one query against one store — metadata only, nothing fetched.

    Plans with pruning + cascading on (the service's execution
    configuration), prices the plan with
    :func:`repro_torch.core.plan.estimate_plan_bytes`, and converts bytes to
    modeled seconds over ``link`` (default: the near-data PCIe tier).
    ``calibration`` is an optional observed/priced ratio prior per stage
    kind (:meth:`repro_torch.obs.metrics.MetricsRegistry.calibration_priors`)
    — the service's feedback loop from settled jobs back into pricing.
    Raises whatever :func:`plan_skim` raises on malformed queries
    (unknown branches etc.) — the service turns that into a rejection.
    """
    from repro_torch.core.engine import PCIE_128G
    from repro_torch.core.plan import estimate_plan_bytes
    from repro_torch.core.planner import plan_skim
    from repro_torch.core.query import Query, parse_query

    q = query if isinstance(query, Query) else parse_query(query)
    window_events = window_events or store.basket_events
    plan = plan_skim(q, store, window_events=window_events, prune=True, cascade=True)
    est = estimate_plan_bytes(plan, store, window_events, calibration=calibration)
    link = link or PCIE_128G
    return CostEstimate(
        est_bytes=est["total"],
        est_phase1_bytes=est["phase1"],
        est_phase2_bytes=est["phase2"],
        est_requests=est["requests"],
        est_wall_s=link.transfer_time(est["total"], est["requests"]),
        est_selectivity=est["est_selectivity"],
        n_windows=est["n_windows"],
        n_windows_pruned=est["n_windows_pruned"],
        per_stage=est["per_stage"],
        per_stage_kinds=est["per_stage_kinds"],
    )


@dataclass(frozen=True)
class TenantQuota:
    """Per-tenant admission budget and fair-share weight.

    ``byte_budget`` caps the sum of priced bytes a tenant may have
    admitted (reserved + settled); ``wall_budget_s`` the same in modeled
    seconds.  ``weight`` scales the tenant's share of the weighted-fair
    queue — a weight-2 tenant drains twice as fast as a weight-1 one.
    """

    byte_budget: float = float("inf")
    wall_budget_s: float = float("inf")
    weight: float = 1.0


@dataclass
class PartialResult:
    """One streamed window-granular ledger entry of a running job.

    ``cols`` holds the window's survivor columns exactly as the final
    output will concatenate them — the union of a completed job's
    partials is bit-identical to the synchronous result (pinned by
    tests/test_service.py).  Cluster-backed jobs stream one entry per
    *shard* instead (``meta["shard_id"]``), with the per-window ledger
    in ``meta["window_rows"]``.
    """

    job_id: int
    seq: int  # per-job stream ordinal (0, 1, 2, ...)
    start: int
    stop: int
    n_passed: int
    cols: dict = field(default_factory=dict)
    jagged: dict = field(default_factory=dict)
    meta: dict = field(default_factory=dict)


@dataclass
class SkimJob:
    """One submitted query and everything the service knows about it."""

    job_id: int
    tenant: str
    query: object
    state: str = PENDING
    estimate: CostEstimate | None = None
    partials: list[PartialResult] = field(default_factory=list)
    result: object = None  # SkimResult / ClusterSkimResult once DONE
    error: str | None = None  # FAILED cause or REJECTED reason
    cancel_requested: bool = False
    submitted_at: float = 0.0
    started_at: float | None = None
    finished_at: float | None = None
    # weighted-fair virtual finish time + submission ordinal (FIFO tiebreak)
    vfinish: float = 0.0
    seq: int = 0
    # journal recovery (repro_torch.serve.journal): windows already streamed
    # before the crash — the restarted executor recomputes but does not
    # re-stream them, so the post-recovery stream is the suffix
    resume_skip: int = 0
    # per-job span tree (repro_torch.obs.trace.Tracer) when the service runs
    # with tracing on; root_span is the job[..] span every lifecycle
    # span parents under
    tracer: object = None
    root_span: int = 0

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL

    @property
    def stats(self) -> FetchStats:
        """The job's fetch ledger: the result's once DONE, an all-zero
        ledger otherwise — a REJECTED job provably moved nothing."""
        if self.result is not None:
            return self.result.stats
        return FetchStats()

    @property
    def n_passed(self) -> int:
        """Survivors streamed so far (== result total once DONE)."""
        return sum(p.n_passed for p in self.partials)

    def windows_streamed(self) -> list[tuple[int, int]]:
        """(start, stop) of every streamed partial, in stream order."""
        return [(p.start, p.stop) for p in self.partials]


def union_columns(job: SkimJob) -> tuple[dict, dict]:
    """Concatenate a job's streamed partial columns in stream order.

    Returns ``(cols, jagged)`` — the branch-wise union of every
    streamed window's survivor columns, which must equal the final
    output bit-for-bit (the streaming contract, DESIGN.md §12).  Jobs
    whose partials carried no columns (nothing passed anywhere) return
    empty dicts.
    """
    per_branch: dict[str, list] = {}
    jagged: dict[str, str] = {}
    for p in job.partials:
        for name, arr in p.cols.items():
            per_branch.setdefault(name, []).append(arr)
        jagged.update(p.jagged)
    cols = {
        name: np.concatenate(parts) for name, parts in per_branch.items()
    }
    return cols, jagged


__all__ = [
    "CANCELLED",
    "DONE",
    "FAILED",
    "PENDING",
    "REJECTED",
    "RUNNING",
    "TERMINAL",
    "CostEstimate",
    "ManualClock",
    "PartialResult",
    "SkimJob",
    "TenantQuota",
    "price_query",
    "union_columns",
]
