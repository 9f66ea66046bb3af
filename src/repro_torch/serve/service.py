"""Async skim job service: queue, cost-based admission, streaming (DESIGN.md §12).

Every engine in this repo is a synchronous library call; this module is
the *service* a multi-tenant front door needs (ROADMAP item 1): jobs are
submitted, priced, admitted against per-tenant quotas, scheduled through
a weighted-fair queue, executed cooperatively one basket window per
quantum, and streamed back window-granular partial results as each
window's ledger entry completes.

Design pillars:

  * **Cost-based admission.**  :func:`~repro_torch.serve.jobs.price_query`
    prices each submission with the cascade cost model *before* it runs
    (basket metadata only).  Over-quota submissions are REJECTED with
    the priced estimate attached and provably zero bytes fetched.
  * **Weighted-fair queueing.**  Each admitted job gets a virtual
    finish time ``vstart + priced_cost / tenant_weight`` (``vstart``
    continues the tenant's backlog); every quantum runs the job with
    the smallest one.  Cheap queries from other tenants therefore
    schedule ahead of — and preempt, at window boundaries — an
    expensive query instead of queueing behind it.
  * **Cooperative execution.**  The engines' streaming generators
    (:meth:`SkimEngine.iter_run`, :meth:`SharedScanEngine.iter_batch`,
    :meth:`ClusterCoordinator.iter_run`) advance one window (or shard)
    per quantum.  Window boundaries are the cancellation points, and
    every yielded partial is appended to ``job.partials`` immediately —
    the union of a completed job's partials is bit-identical to the
    synchronous result by construction.
  * **Determinism.**  One thread, an injectable
    :class:`~repro_torch.serve.jobs.ManualClock`, and a
    :class:`DeterministicExecutor` that records every scheduling
    decision in a replayable trace.  No sleeps anywhere; tests replay
    schedules exactly.
  * **Batch coalescing.**  With ``batching=True``, compatible queued
    jobs start as ONE :meth:`SharedScanEngine.iter_batch` pass —
    phase 1 amortizes across tenants while each job still streams its
    own partials and finishes with its own bit-identical result.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

from repro_torch.core.engine import SkimEngine, WindowPartial
from repro_torch.obs.metrics import (
    MetricsRegistry,
    observed_phase2_bytes,
    observed_stage_bytes,
    priced_stage_bytes,
)
from repro_torch.obs.trace import Tracer, chrome_trace, trace_json
from repro_torch.serve.engine import SharedScanEngine
from repro_torch.serve.journal import JobJournal
from repro_torch.serve.jobs import (
    CANCELLED,
    DONE,
    FAILED,
    PENDING,
    REJECTED,
    RUNNING,
    CostEstimate,
    ManualClock,
    PartialResult,
    SkimJob,
    TenantQuota,
    price_query,
)

#: bytes per unit of virtual time (WFQ cost currency: priced megabytes)
COST_SCALE_BYTES = 1e6


class ServiceError(RuntimeError):
    """Typed failure of the service layer itself (not of any one job) —
    e.g. the quantum budget exhausting with jobs still live.  Subclasses
    ``RuntimeError`` so pre-existing ``except RuntimeError`` callers keep
    working; the skim fabric's D004 lint requires the typed form."""


# ---------------------------------------------------------------------------
# backends: where a job actually executes
# ---------------------------------------------------------------------------


class EngineBackend:
    """Single-store backend: solo jobs run on
    :meth:`SkimEngine.iter_run`, coalesced batches on
    :meth:`SharedScanEngine.iter_batch` — both stream
    :class:`~repro_torch.core.engine.WindowPartial` per basket window.
    The shared engine runs where the solo engine runs (its ``device``
    and ``fused_backend``)."""

    supports_batch = True

    def __init__(
        self,
        store,
        engine: SkimEngine | None = None,
        shared: SharedScanEngine | None = None,
        mode: str = "near_data",
        **engine_kw,
    ):
        self.store = store
        self.engine = engine or SkimEngine(store, **engine_kw)
        self.shared = shared or SharedScanEngine(
            store,
            chunk_events=self.engine.chunk_events,
            fused=self.engine.fused,
            prune=self.engine.prune,
            cascade=self.engine.cascade,
            device=self.engine.device,
            fused_backend=self.engine.fused_backend,
        )
        self.mode = mode

    def price(self, query, calibration: dict | None = None) -> CostEstimate:
        return price_query(
            query,
            self.store,
            window_events=self.engine.chunk_events,
            link=self.engine.near_input_link,
            calibration=calibration,
        )

    def start(self, query, tracer=None):
        return self.engine.iter_run(query, mode=self.mode, tracer=tracer)

    def start_batch(self, queries, tracer=None):
        return self.shared.iter_batch(queries, tracer=tracer)


class ClusterBackend:
    """Scatter-gather backend: a job fans out over the coordinator's
    shards and streams one partial per *shard* response (each carrying
    its per-window ledger) as the gather progresses."""

    supports_batch = False

    def __init__(self, coordinator):
        self.coordinator = coordinator

    def price(self, query, calibration: dict | None = None) -> CostEstimate:
        parts = [
            price_query(
                query,
                node.shard.store,
                window_events=node.shard.window_events,
                link=node.near_input_link,
                calibration=calibration,
            )
            for node in self.coordinator.nodes
        ]
        per_stage: dict[int, int] = {}
        per_stage_kinds: dict[int, str] = {}
        for p in parts:
            for si, v in p.per_stage.items():
                per_stage[si] = per_stage.get(si, 0) + v
            per_stage_kinds.update(p.per_stage_kinds)
        n_events = sum(
            node.shard.store.n_events for node in self.coordinator.nodes
        )
        return CostEstimate(
            est_bytes=sum(p.est_bytes for p in parts),
            est_phase1_bytes=sum(p.est_phase1_bytes for p in parts),
            est_phase2_bytes=sum(p.est_phase2_bytes for p in parts),
            est_requests=sum(p.est_requests for p in parts),
            # shards serve in parallel: the modeled wall is the slowest
            est_wall_s=max((p.est_wall_s for p in parts), default=0.0),
            est_selectivity=(
                sum(
                    p.est_selectivity * node.shard.store.n_events
                    for p, node in zip(parts, self.coordinator.nodes)
                )
                / max(n_events, 1)
            ),
            n_windows=sum(p.n_windows for p in parts),
            n_windows_pruned=sum(p.n_windows_pruned for p in parts),
            per_stage=per_stage,
            per_stage_kinds=per_stage_kinds,
        )

    def start(self, query, tracer=None):
        return self._gen(query, tracer)

    def _gen(self, query, tracer=None):
        it = self.coordinator.iter_run(query, tracer=tracer)
        while True:
            try:
                resp = next(it)
            except StopIteration as stop:
                return stop.value
            rows = resp.result.extras.get("window_rows", [])
            try:
                yield WindowPartial(
                    index=resp.shard_id,
                    start=rows[0][0] if rows else 0,
                    stop=rows[-1][1] if rows else 0,
                    n_passed=resp.result.n_passed,
                    cols={},
                    jagged={},
                    decision=f"shard:{resp.shard_id}",
                )
            except GeneratorExit:
                # close the coordinator promptly so its tracer's root
                # span settles now, not at garbage collection
                it.close()
                raise


# ---------------------------------------------------------------------------
# scheduler internals
# ---------------------------------------------------------------------------


@dataclass
class _TenantState:
    quota: TenantQuota
    reserved_bytes: float = 0.0  # priced bytes of admitted, unfinished jobs
    spent_bytes: float = 0.0  # observed bytes of finished jobs
    reserved_wall_s: float = 0.0
    spent_wall_s: float = 0.0
    vlast: float = 0.0  # tenant's last virtual finish (backlog tail)


@dataclass
class _Run:
    """One open executor generator: a solo job or a coalesced batch."""

    gen: object
    jobs: list[SkimJob]
    batch: bool = False
    windows: int = 0  # quanta advanced so far


class DeterministicExecutor:
    """Single-threaded cooperative quantum runner.

    The injectable executor seam: the service hands it one quantum
    (advance one run unit by one window) at a time, and it records a
    replayable trace of every scheduling decision —
    ``(quantum, picked_job_id, run_member_ids)``.  Single-threaded by
    construction, so two runs over the same submissions make identical
    decisions in identical order.
    """

    def __init__(self):
        self.trace: list[tuple[int, int, tuple[int, ...]]] = []
        self.quanta = 0

    def run_quantum(self, fn, picked: int, members: tuple[int, ...]):
        self.quanta += 1
        self.trace.append((self.quanta, picked, members))
        return fn()


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------


class SkimService:
    """Multi-tenant async skim job service over one execution backend.

    ``backend`` is an :class:`EngineBackend` (single store; supports
    batch coalescing) or :class:`ClusterBackend` (scatter-gather).  A
    bare :class:`~repro_torch.data.store.EventStore` is wrapped in an
    :class:`EngineBackend` for convenience.  ``quotas`` maps tenant
    name -> :class:`~repro_torch.serve.jobs.TenantQuota`; unknown tenants get
    the (unlimited, weight-1) default.  ``clock`` and ``executor`` are
    the deterministic seams — inject your own to control timestamps and
    observe scheduling.

    The service is cooperative and single-threaded: nothing executes
    until :meth:`step` (one scheduling quantum = one basket window of
    one job), :meth:`run_until_idle`, :meth:`result`, or
    :meth:`stream` drives it.
    """

    def __init__(
        self,
        backend,
        quotas: dict[str, TenantQuota] | None = None,
        clock: ManualClock | None = None,
        executor: DeterministicExecutor | None = None,
        batching: bool = False,
        tracing: bool = False,
        metrics: MetricsRegistry | None = None,
        calibrate: bool = False,
        journal: JobJournal | None = None,
    ):
        if not hasattr(backend, "start"):
            backend = EngineBackend(backend)
        self.backend = backend
        self.quotas = dict(quotas or {})
        self.clock = clock or ManualClock()
        self.executor = executor or DeterministicExecutor()
        self.batching = batching and backend.supports_batch
        # observability seams (DESIGN.md §13): ``tracing`` gives every
        # job its own span tree (export with :meth:`export_trace`);
        # ``metrics`` is the shared registry (a private one by default);
        # ``calibrate`` feeds settled jobs' observed/priced ratios back
        # into admission pricing as per-stage-kind priors
        self.tracing = tracing
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.calibrate = calibrate
        # durability seam (DESIGN.md §14): every lifecycle transition is
        # appended to the journal before the service moves on, and
        # :meth:`recover` replays a journal into a fresh service.
        # Journaling requires JSON-able query docs (dict/str).
        self.journal = journal
        self._batch_tracers: list[Tracer] = []
        self.jobs: dict[int, SkimJob] = {}
        self._tenants: dict[str, _TenantState] = {}
        self._runs: dict[int, _Run] = {}  # job_id -> its run unit
        self._ids = itertools.count(1)
        self._seq = itertools.count()
        self._vtime = 0.0  # virtual time of the last service start

    # -- tenants -------------------------------------------------------------

    def _tenant(self, name: str) -> _TenantState:
        if name not in self._tenants:
            self._tenants[name] = _TenantState(
                self.quotas.get(name, TenantQuota())
            )
        return self._tenants[name]

    def tenant_usage(self, name: str) -> dict:
        ts = self._tenant(name)
        return {
            "reserved_bytes": ts.reserved_bytes,
            "spent_bytes": ts.spent_bytes,
            "reserved_wall_s": ts.reserved_wall_s,
            "spent_wall_s": ts.spent_wall_s,
            "byte_budget": ts.quota.byte_budget,
            "wall_budget_s": ts.quota.wall_budget_s,
            "weight": ts.quota.weight,
        }

    # -- submission / admission ----------------------------------------------

    def submit(self, query, tenant: str = "default") -> SkimJob:
        """Price, admit (or reject), and enqueue one query.

        Never blocks and never fetches: pricing is basket metadata only.
        The returned job is PENDING (admitted — it will run when the
        fair queue reaches it) or REJECTED (``job.error`` says why,
        ``job.estimate`` carries the price that condemned it, and
        ``job.stats`` is all-zero).
        """
        job = SkimJob(
            job_id=next(self._ids),
            tenant=tenant,
            query=query,
            submitted_at=self.clock.now(),
            seq=next(self._seq),
        )
        if self.tracing:
            job.tracer = Tracer(
                clock=self.clock, name=f"job-{job.job_id}", detail=False
            )
            job.root_span = job.tracer.begin(
                f"job[{job.job_id}]", kind="job",
                job_id=job.job_id, tenant=tenant,
            )
        self.jobs[job.job_id] = job
        if self.journal is not None:
            self.journal.append(
                "submit", job.job_id, job.submitted_at,
                tenant=tenant, seq=job.seq, query=query,
            )
        ts = self._tenant(tenant)
        calib = self.metrics.calibration_priors() if self.calibrate else None
        try:
            est = (
                self.backend.price(query, calibration=calib)
                if calib
                else self.backend.price(query)
            )
        except Exception as exc:  # malformed query: reject at the door
            return self._reject(job, f"unpriceable query: {exc}")
        job.estimate = est
        q = ts.quota
        byte_used = ts.reserved_bytes + ts.spent_bytes
        if byte_used + est.est_bytes > q.byte_budget:
            return self._reject(
                job,
                f"over byte quota: priced {est.est_bytes} B, "
                f"{q.byte_budget - byte_used:.0f} B left of "
                f"{q.byte_budget:.0f} B budget ({est.describe()})",
            )
        wall_used = ts.reserved_wall_s + ts.spent_wall_s
        if wall_used + est.est_wall_s > q.wall_budget_s:
            return self._reject(
                job,
                f"over wall-clock quota: priced {est.est_wall_s:.4f} s, "
                f"{q.wall_budget_s - wall_used:.4f} s left of "
                f"{q.wall_budget_s:.4f} s budget ({est.describe()})",
            )
        ts.reserved_bytes += est.est_bytes
        ts.reserved_wall_s += est.est_wall_s
        # weighted-fair virtual finish: continue the tenant's backlog,
        # never start in the past
        cost = est.est_bytes / COST_SCALE_BYTES
        vstart = max(self._vtime, ts.vlast)
        job.vfinish = vstart + cost / max(q.weight, 1e-9)
        ts.vlast = job.vfinish
        if job.tracer is not None:
            job.tracer.add_span(
                "admission", kind="admission",
                t0=job.submitted_at, t1=self.clock.now(),
                parent=job.root_span,
                admitted=True, est_bytes=est.est_bytes,
            )
        if self.journal is not None:
            self.journal.append(
                "admit", job.job_id, self.clock.now(),
                vfinish=job.vfinish,
                est_bytes=est.est_bytes,
                est_phase1_bytes=est.est_phase1_bytes,
                est_phase2_bytes=est.est_phase2_bytes,
                est_requests=est.est_requests,
                est_wall_s=est.est_wall_s,
                est_selectivity=est.est_selectivity,
                n_windows=est.n_windows,
                n_windows_pruned=est.n_windows_pruned,
            )
        self.metrics.inc("service_jobs_submitted", tenant=tenant)
        return job

    def _reject(self, job: SkimJob, reason: str) -> SkimJob:
        job.state = REJECTED
        job.error = reason
        job.finished_at = self.clock.now()
        if job.tracer is not None:
            job.tracer.add_span(
                "admission", kind="admission",
                t0=job.submitted_at, t1=job.finished_at,
                parent=job.root_span,
                admitted=False, reason=reason,
            )
            job.tracer.end(job.root_span, state=REJECTED)
        if self.journal is not None:
            self.journal.append(
                "reject", job.job_id, job.finished_at, reason=reason
            )
        self.metrics.inc("service_jobs_submitted", tenant=job.tenant)
        self.metrics.inc(
            "service_jobs_total", state=REJECTED, tenant=job.tenant
        )
        return job

    # -- cancellation --------------------------------------------------------

    def cancel(self, job_id: int) -> bool:
        """Cancel a job.  PENDING jobs leave the queue immediately;
        RUNNING jobs stop at the current window boundary (cooperative —
        the service is between quanta whenever this can be called), keep
        the partials they already streamed, and settle CANCELLED.  A
        batch member's cancellation never aborts the shared pass the
        other tenants are riding.  Returns ``False`` for jobs already
        terminal."""
        job = self.jobs[job_id]
        if job.terminal:
            return False
        job.cancel_requested = True
        if job.state == RUNNING:
            run = self._runs.pop(job.job_id, None)
            if run is not None and not run.batch:
                run.gen.close()
        self._settle(job, CANCELLED)
        return True

    # -- scheduling ----------------------------------------------------------

    def _runnable(self) -> SkimJob | None:
        """The weighted-fair pick: smallest virtual finish time wins,
        submission order breaks ties."""
        best = None
        for job in self.jobs.values():
            if job.state in (PENDING, RUNNING):
                key = (job.vfinish, job.seq)
                if best is None or key < (best.vfinish, best.seq):
                    best = job
        return best

    def step(self) -> bool:
        """Run ONE scheduling quantum: pick the fair-queue head, advance
        its run unit by one basket window (starting it first if
        pending), deliver the streamed partial.  Returns ``False`` when
        no job is runnable (the service is idle)."""
        job = self._runnable()
        if job is None:
            return False
        run = self._runs.get(job.job_id)
        if run is None:
            run = self._start(job)
            if run is None:  # start itself failed -> job already settled
                return True
        members = tuple(j.job_id for j in run.jobs)
        self.executor.run_quantum(
            lambda: self._advance(run), job.job_id, members
        )
        return True

    def run_until_idle(self, max_quanta: int = 1_000_000) -> int:
        """Drive quanta until every job is terminal; returns how many ran."""
        n = 0
        while self.step():
            n += 1
            if n >= max_quanta:
                raise ServiceError(
                    f"service still busy after {max_quanta} quanta"
                )
        return n

    def result(self, job_id: int) -> SkimJob:
        """Drive the service until ``job_id`` is terminal; return it."""
        job = self.jobs[job_id]
        while not job.terminal and self.step():
            pass
        return job

    def stream(self, job_id: int):
        """Generator of the job's :class:`PartialResult`\\ s, driving the
        scheduler as needed: yields each streamed window as soon as the
        fair queue lets the job produce it, ends when the job is
        terminal.  Other tenants' quanta interleave underneath — this is
        the subscriber's view of one job, not a private executor."""
        job = self.jobs[job_id]
        i = 0
        while True:
            while i < len(job.partials):
                yield job.partials[i]
                i += 1
            if job.terminal or not self.step():
                return

    # -- run units -----------------------------------------------------------

    def _start(self, job: SkimJob) -> _Run | None:
        """Open the executor generator for a pending job — or, with
        batching on, for EVERY pending job as one coalesced shared
        scan."""
        now = self.clock.now()
        if self.batching and not job.resume_skip:
            # recovered mid-stream jobs run solo: their fast-forward
            # watermark has no meaning inside a coalesced batch
            members = sorted(
                (
                    j for j in self.jobs.values()
                    if j.state == PENDING and not j.resume_skip
                ),
                key=lambda j: (j.vfinish, j.seq),
            )
        else:
            members = [job]
        try:
            if len(members) > 1:
                # a coalesced batch executes under ONE shared tracer (the
                # scan is genuinely shared work); per-job tracers keep
                # their own admission/queue/settle lifecycle spans
                btr = None
                if self.tracing:
                    btr = Tracer(
                        clock=self.clock,
                        name=f"batch-{len(self._batch_tracers)}",
                        detail=False,
                    )
                    self._batch_tracers.append(btr)
                gen = self.backend.start_batch(
                    [j.query for j in members], tracer=btr
                )
                run = _Run(gen=gen, jobs=members, batch=True)
            else:
                members = [job]
                gen = (
                    self.backend.start(job.query, tracer=job.tracer)
                    if job.tracer is not None
                    else self.backend.start(job.query)
                )
                run = _Run(gen=gen, jobs=members)
        except Exception as exc:
            job.error = f"{type(exc).__name__}: {exc}"
            self._settle(job, FAILED)
            return None
        for j in run.jobs:
            if j.tracer is not None:
                j.tracer.add_span(
                    "queue_wait", kind="queue",
                    t0=j.submitted_at, t1=now, parent=j.root_span,
                )
            self.metrics.observe(
                "service_queue_wait_s", now - j.submitted_at
            )
            j.state = RUNNING
            j.started_at = now
            self._runs[j.job_id] = run
            if self.journal is not None:
                self.journal.append(
                    "start", j.job_id, now, resume=j.resume_skip
                )
        # virtual time advances to the service start of the picked job
        self._vtime = max(self._vtime, job.vfinish)
        if not run.batch and job.resume_skip:
            # journal recovery: deterministically re-advance the fresh
            # generator past the windows whose partials were already
            # streamed before the crash — recomputed, never re-streamed,
            # so the post-recovery stream is exactly the suffix
            try:
                for _ in range(job.resume_skip):
                    next(run.gen)
            except StopIteration as stop:
                # the crash hit after the final window: settle directly
                self._finish(run, stop.value)
                return None
            except Exception as exc:
                self._fail(run, exc)
                return None
        return run

    def _advance(self, run: _Run) -> None:
        """One quantum: advance the generator one window and dispatch."""
        try:
            part = next(run.gen)
        except StopIteration as stop:
            self._finish(run, stop.value)
        except Exception as exc:
            self._fail(run, exc)
        else:
            run.windows += 1
            self._deliver(run, part)

    def _deliver(self, run: _Run, part) -> None:
        if run.batch:
            for i, j in enumerate(run.jobs):
                if j.state == RUNNING:
                    self._append_partial(j, part.tenants[i])
        else:
            self._append_partial(run.jobs[0], part)

    def _append_partial(self, job: SkimJob, wp: WindowPartial) -> None:
        job.partials.append(
            PartialResult(
                job_id=job.job_id,
                seq=len(job.partials),
                start=wp.start,
                stop=wp.stop,
                n_passed=wp.n_passed,
                cols=wp.cols,
                jagged=wp.jagged,
                meta={"decision": wp.decision, "window": wp.index},
            )
        )
        if self.journal is not None:
            # the watermark seq is GLOBAL across crashes: a recovered
            # job's suffix continues where the journaled prefix stopped
            self.journal.append(
                "window", job.job_id, self.clock.now(),
                seq=job.resume_skip + len(job.partials) - 1,
                start=wp.start, stop=wp.stop, n_passed=wp.n_passed,
            )
        if len(job.partials) == 1:
            self.metrics.observe(
                "service_first_partial_s",
                self.clock.now() - job.submitted_at,
            )

    def _finish(self, run: _Run, value) -> None:
        if run.batch:
            results = value.results  # SharedScanResult, request order
            for i, j in enumerate(run.jobs):
                if j.state != RUNNING:
                    continue  # cancelled mid-batch: already settled
                j.result = results[i]
                self._runs.pop(j.job_id, None)
                self._settle(j, DONE)
        else:
            job = run.jobs[0]
            job.result = value
            self._runs.pop(job.job_id, None)
            self._settle(job, DONE)

    def _fail(self, run: _Run, exc: Exception) -> None:
        cause = f"{type(exc).__name__}: {exc}"
        for j in run.jobs:
            self._runs.pop(j.job_id, None)
            if not j.terminal:
                j.error = cause
                self._settle(j, FAILED)

    def _settle(self, job: SkimJob, state: str) -> None:
        """Terminal-state bookkeeping: release the admission
        reservation; DONE jobs charge their *observed* ledger (the
        estimate trues up against reality, so a tenant's budget drains
        by what it actually moved)."""
        job.state = state
        job.finished_at = self.clock.now()
        ts = self._tenant(job.tenant)
        if job.estimate is not None:
            ts.reserved_bytes -= job.estimate.est_bytes
            ts.reserved_wall_s -= job.estimate.est_wall_s
        if state == DONE and job.result is not None:
            ts.spent_bytes += job.result.stats.bytes_fetched
            ts.spent_wall_s += _modeled_seconds(job.result)
            self._record_calibration(job)
        if self.journal is not None:
            observed = (
                job.result.stats.bytes_fetched
                if job.result is not None
                else 0
            )
            self.journal.append(
                "settle", job.job_id, job.finished_at,
                state=state, error=job.error,
                observed_bytes=observed,
                modeled_s=(
                    _modeled_seconds(job.result)
                    if state == DONE and job.result is not None
                    else 0.0
                ),
            )
        self.metrics.inc("service_jobs_total", state=state, tenant=job.tenant)
        self.metrics.set_gauge(
            "tenant_spent_bytes", ts.spent_bytes, tenant=job.tenant
        )
        self.metrics.set_gauge(
            "tenant_reserved_bytes", ts.reserved_bytes, tenant=job.tenant
        )
        if job.tracer is not None:
            observed = (
                job.result.stats.bytes_fetched
                if job.result is not None
                else 0
            )
            job.tracer.add_span(
                "settle", kind="settle",
                t0=job.finished_at, t1=job.finished_at,
                parent=job.root_span,
                state=state,
                observed_bytes=observed,
                priced_bytes=(
                    job.estimate.est_bytes
                    if job.estimate is not None
                    else None
                ),
            )
            job.tracer.end(job.root_span, state=state)

    def _record_calibration(self, job: SkimJob) -> None:
        """Feed one DONE job's observed ledger back against its priced
        estimate: total bytes, the phase-2 split when the result reports
        one, and per-cascade-stage-kind bytes (the prior
        :func:`~repro_torch.core.plan.estimate_plan_bytes` consumes)."""
        est = job.estimate
        if est is None or job.result is None:
            return
        self.metrics.record_price_ratio(
            "total", est.est_bytes, job.result.stats.bytes_fetched
        )
        p2 = observed_phase2_bytes(job.result)
        if p2 is not None and est.est_phase2_bytes > 0:
            self.metrics.record_price_ratio(
                "phase2", est.est_phase2_bytes, p2
            )
        observed = observed_stage_bytes(job.result)
        for kind, priced in priced_stage_bytes(est).items():
            if kind in observed:
                self.metrics.record_price_ratio(kind, priced, observed[kind])

    # -- introspection -------------------------------------------------------

    @property
    def trace(self):
        """The executor's replayable decision log."""
        return self.executor.trace

    def calibration_summary(self) -> dict:
        """Priced-vs-observed byte totals (and ratio) per cascade-stage
        kind, accumulated from every DONE job."""
        return self.metrics.calibration_summary()

    def export_trace(self, path: str | None = None) -> dict:
        """Assemble every traced job (and coalesced batch) into ONE
        Chrome-trace document — one ``pid`` per job, batch passes on
        pids from 10000 — and optionally write its canonical JSON to
        ``path``.  Requires ``tracing=True``; returns the document."""
        groups = [
            (job.job_id, f"job-{job.job_id} [{job.tenant}]", job.tracer)
            for job in self.jobs.values()
            if job.tracer is not None
        ]
        groups += [
            (10_000 + i, btr.name, btr)
            for i, btr in enumerate(self._batch_tracers)
        ]
        doc = chrome_trace(groups)
        if path is not None:
            with open(path, "w") as fh:
                fh.write(trace_json(doc))
        return doc

    # -- durability ----------------------------------------------------------

    @classmethod
    def recover(cls, journal: JobJournal, backend, **service_kw) -> "SkimService":
        """Reconstruct a service from a :class:`JobJournal` after a crash.

        Replays the journal's lifecycle records into a fresh service
        over ``backend`` (which must serve the same data — the journal
        stores queries and watermarks, not baskets):

          * terminal jobs return with state, error, and settle-time
            tenant accounting;
          * admitted PENDING jobs re-enter the fair queue with their
            journaled estimate and virtual finish time;
          * jobs journaled RUNNING resume from their window watermark —
            the restarted generator recomputes the already-streamed
            windows without re-streaming them, so the post-recovery
            stream equals the uninterrupted run's suffix and the final
            result is bit-identical (pinned by tests/test_journal.py).

        The returned service keeps journaling to the same journal, so
        recovery composes across repeated crashes.
        """
        svc = cls(backend, **service_kw)
        by_job: dict[int, dict] = {}
        for rec in journal.records():
            svc.metrics.inc("journal_replays_total", event=rec["event"])
            d = by_job.setdefault(rec["job_id"], {"watermark": -1})
            ev = rec["event"]
            if ev == "window":
                d["watermark"] = max(d["watermark"], rec["seq"])
            else:
                d[ev] = rec
        max_id, max_seq = 0, -1
        for jid in sorted(by_job):
            d = by_job[jid]
            sub = d.get("submit")
            if sub is None:
                continue  # torn journal head: nothing to rebuild from
            max_id = max(max_id, jid)
            max_seq = max(max_seq, sub["seq"])
            job = SkimJob(
                job_id=jid,
                tenant=sub["tenant"],
                query=sub["query"],
                submitted_at=sub["t"],
                seq=sub["seq"],
            )
            svc.jobs[jid] = job
            ts = svc._tenant(job.tenant)
            rej = d.get("reject")
            if rej is not None:
                job.state = REJECTED
                job.error = rej["reason"]
                job.finished_at = rej["t"]
                continue
            adm = d.get("admit")
            if adm is not None:
                job.estimate = CostEstimate(
                    est_bytes=adm["est_bytes"],
                    est_phase1_bytes=adm["est_phase1_bytes"],
                    est_phase2_bytes=adm["est_phase2_bytes"],
                    est_requests=adm["est_requests"],
                    est_wall_s=adm["est_wall_s"],
                    est_selectivity=adm["est_selectivity"],
                    n_windows=adm["n_windows"],
                    n_windows_pruned=adm["n_windows_pruned"],
                )
                job.vfinish = adm["vfinish"]
                ts.vlast = max(ts.vlast, job.vfinish)
            st = d.get("settle")
            if st is not None:
                job.state = st["state"]
                job.error = st.get("error")
                job.finished_at = st["t"]
                ts.spent_bytes += st.get("observed_bytes", 0)
                ts.spent_wall_s += st.get("modeled_s", 0.0)
                svc._vtime = max(svc._vtime, job.vfinish)
                continue
            # PENDING (admitted, never started) or RUNNING (crashed
            # mid-stream): both re-enter the queue; the latter carries
            # its fast-forward watermark
            if job.estimate is not None:
                ts.reserved_bytes += job.estimate.est_bytes
                ts.reserved_wall_s += job.estimate.est_wall_s
            job.state = PENDING
            if d.get("start") is not None:
                job.resume_skip = d["watermark"] + 1
                svc._vtime = max(svc._vtime, job.vfinish)
            if svc.tracing:
                job.tracer = Tracer(
                    clock=svc.clock, name=f"job-{jid}", detail=False
                )
                job.root_span = job.tracer.begin(
                    f"job[{jid}]", kind="job", job_id=jid, tenant=job.tenant
                )
                job.tracer.add_span(
                    "recover", kind="recover",
                    t0=svc.clock.now(), t1=svc.clock.now(),
                    parent=job.root_span,
                    resume_skip=job.resume_skip,
                )
        svc._ids = itertools.count(max_id + 1)
        svc._seq = itertools.count(max_seq + 1)
        svc.journal = journal
        return svc

    def queue_depth(self) -> int:
        return sum(
            1 for j in self.jobs.values() if j.state in (PENDING, RUNNING)
        )

    def describe(self) -> str:
        by_state: dict[str, int] = {}
        for j in self.jobs.values():
            by_state[j.state] = by_state.get(j.state, 0) + 1
        states = ", ".join(f"{k}={v}" for k, v in sorted(by_state.items()))
        return (
            f"SkimService({states or 'empty'}, "
            f"quanta={self.executor.quanta}, batching={self.batching})"
        )


def _modeled_seconds(result) -> float:
    """A finished job's modeled wall-clock, in the same currency the
    admission estimate priced (link + measured stages)."""
    total = getattr(result, "modeled_total_s", None)  # ClusterSkimResult
    if total is not None:
        return total
    return result.extras.get("pipeline_total", result.breakdown.total())


__all__ = [
    "COST_SCALE_BYTES",
    "ClusterBackend",
    "DeterministicExecutor",
    "EngineBackend",
    "SkimService",
]
